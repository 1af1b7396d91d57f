"""The write-behind queue: annotation writes made during an API outage,
kept on disk until the API heals.

The counterpart of ``gpumounter_tpu/store/writebehind.py``. The master's
durable state is annotations (``store/k8s.py``); when the API server cannot
be reached, the degraded store (``store/cache.py``) logs the write here and
answers its caller, and replays it when the API heals. One JSON object a
line, fsync'd, as the worker's ledger (``worker/ledger.py``):

  write   {"kind": "write", "seq": N, "namespace", "pod", "annotation",
           "payload": str or null, "queued_at": ts}
  done    {"kind": "done", "seq": N, "outcome"}: applied, superseded,
          pod-gone or lost-cas

A write without its done is pending. ``flush`` applies the pending writes
in order and appends a done after each, so that a death in a flush applies
at most the one write whose done was lost again, and a merge patch applied
twice is the same patch. A second write of the same (namespace, pod,
annotation) supersedes the first (its done is appended): a flush applies
the newest value once. A payload that is a JSON object with an integer
"seq" or "generation" is a CAS: when the pod's current annotation carries
a counter as high or higher, the queued write is dropped as lost-cas, never
rolling the annotation back.

``directory`` "" keeps the queue in memory (lost on restart); a directory
holds ``writebehind.jsonl``, read back at construction, and compacted past
``max_bytes`` into the pending writes alone by a temporary file and a
rename. Two steps go past the reference (``utils/jsonl.py``). A torn last
line (its write was never acknowledged) is dropped and cut off the file, so
that the next record starts a line of its own: the reference leaves it, and
the next acknowledged write is lost with it at the following reload. And
the directory is fsync'd when the file is created and after each
compaction, so that after a node crash its entry names the file the fsync'd
lines went into. Series: ``tpumounter_writebehind_pending``,
``tpumounter_writebehind_queued_total`` and
``tpumounter_writebehind_replayed_total`` by outcome.
"""

from __future__ import annotations

import json
import os
import threading
import time

from gpumounter_tpu_torch.k8s.errors import NotFoundError, is_outage
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.utils.jsonl import fsync_dir as _fsync_dir
from gpumounter_tpu_torch.utils.jsonl import read_records
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("store.writebehind")

QUEUE_FILE = "writebehind.jsonl"

WRITEBEHIND_PENDING = REGISTRY.gauge(
    "tpumounter_writebehind_pending",
    "Annotation writes deferred during an API outage, not yet replayed")
WRITEBEHIND_QUEUED = REGISTRY.counter(
    "tpumounter_writebehind_queued_total",
    "Annotation writes accepted into the write-behind queue")
WRITEBEHIND_REPLAYED = REGISTRY.counter(
    "tpumounter_writebehind_replayed_total",
    "Write-behind records closed at replay, by outcome")


class WriteBehindQueue:
    """A process's durable queue of deferred annotation writes."""

    def __init__(self, directory: str = "", max_bytes: int = 4 * 1024 * 1024):
        self.directory = directory
        self.path = os.path.join(directory, QUEUE_FILE) if directory else ""
        self.max_bytes = max(4096, int(max_bytes))
        self._lock = threading.Lock()
        self._seq = 0
        #: seq -> write record, in the order queued
        self._pending: dict[int, dict] = {}
        self._closed_counts: dict[str, int] = {}
        self._fd: int | None = None
        if self.path:
            os.makedirs(directory, exist_ok=True)
            created = not os.path.exists(self.path)
            self._load()
            self._fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600)
            if created:
                _fsync_dir(directory)
        WRITEBEHIND_PENDING.set(float(len(self._pending)))

    # --- load and append ---

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        records, dropped = read_records(self.path)
        for record in records:
            self._apply(record)
        if dropped:
            logger.warning("write-behind %s: dropped %d torn line(s)", self.path, dropped)
        if self._pending:
            logger.info("write-behind %s: %d write(s) pending from a previous run", self.path,
                        len(self._pending))

    def _apply(self, record: dict) -> None:
        kind = record.get("kind")
        if kind == "write":
            seq = int(record.get("seq", 0))
            self._pending[seq] = record
            self._seq = max(self._seq, seq)
        elif kind == "done":
            closed = self._pending.pop(int(record.get("seq", -1)), None)
            if closed is not None:
                self._count_closed(record.get("outcome", "?"))

    def _count_closed(self, outcome: str) -> None:
        self._closed_counts[outcome] = self._closed_counts.get(outcome, 0) + 1

    def _append(self, record: dict) -> None:
        if self._fd is None:
            return  # in memory: _pending is the state
        os.write(self._fd, (json.dumps(record, separators=(",", ":")) + "\n").encode())
        os.fsync(self._fd)

    # --- the outage's write path ---

    def enqueue(self, namespace: str, pod: str, annotation: str, payload: str | None) -> int:
        """Defer one annotation write (payload None clears it); a pending
        write of the same key is superseded. Returns the seq."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            record = {"kind": "write", "seq": seq, "namespace": namespace, "pod": pod,
                      "annotation": annotation, "payload": payload, "queued_at": time.time()}
            superseded = [s for s, r in self._pending.items()
                          if (r["namespace"], r["pod"], r["annotation"])
                          == (namespace, pod, annotation)]
            self._append(record)
            self._pending[seq] = record
            for old_seq in superseded:
                self._append({"kind": "done", "seq": old_seq, "outcome": "superseded"})
                del self._pending[old_seq]
                self._count_closed("superseded")
                WRITEBEHIND_REPLAYED.inc(outcome="superseded")
            WRITEBEHIND_QUEUED.inc()
            WRITEBEHIND_PENDING.set(float(len(self._pending)))
            self._maybe_compact_locked()
        logger.info("write-behind: deferred %s on %s/%s (seq %d%s)", annotation, namespace, pod,
                    seq, f", superseding {superseded}" if superseded else "")
        return seq

    # --- the replay ---

    @staticmethod
    def _counter_of(payload: str | None) -> int | None:
        """The CAS counter ("seq" or "generation") of a JSON-object payload."""
        if not payload:
            return None
        try:
            obj = json.loads(payload)
        except ValueError:
            return None
        if not isinstance(obj, dict):
            return None
        for key in ("seq", "generation"):
            if isinstance(obj.get(key), int):
                return obj[key]
        return None

    def flush(self, kube, max_records: int | None = None) -> dict:
        """Apply the pending writes in order. An outage-shaped failure stops
        the flush (the rest stay pending); a 404 or any other failure closes
        the record as pod-gone. Returns {"applied", "pod_gone", "lost_cas",
        "pending", "error"}."""
        summary = {"applied": 0, "pod_gone": 0, "lost_cas": 0, "pending": 0, "error": ""}
        while True:
            with self._lock:
                ordered = sorted(self._pending)
                if not ordered or (max_records is not None
                                   and summary["applied"] >= max_records):
                    summary["pending"] = len(self._pending)
                    return summary
                seq = ordered[0]
                record = dict(self._pending[seq])
            try:
                outcome = self._replay_one(kube, record)
            except Exception as exc:  # noqa: BLE001 — the outage boundary
                if is_outage(exc):
                    summary["error"] = f"{type(exc).__name__}: {exc}"
                    with self._lock:
                        summary["pending"] = len(self._pending)
                    logger.warning("write-behind flush halted at seq %d (%d still pending): "
                                   "%s", seq, summary["pending"], exc)
                    return summary
                if not isinstance(exc, NotFoundError):
                    # a bad request cannot succeed later either
                    logger.error("write-behind seq %d unreplayable: %s", seq, exc)
                outcome = "pod-gone"
            with self._lock:
                if seq in self._pending:
                    self._append({"kind": "done", "seq": seq, "outcome": outcome})
                    del self._pending[seq]
                    self._count_closed(outcome)
                    WRITEBEHIND_PENDING.set(float(len(self._pending)))
                    self._maybe_compact_locked()
            WRITEBEHIND_REPLAYED.inc(outcome=outcome)
            key = outcome.replace("-", "_")
            summary[key] = summary.get(key, 0) + 1

    def _replay_one(self, kube, record: dict) -> str:
        """Apply one record; its outcome. Raises an outage and NotFoundError."""
        namespace, pod_name = record["namespace"], record["pod"]
        annotation, payload = record["annotation"], record["payload"]
        queued = self._counter_of(payload)
        if queued is not None:
            current = self._counter_of(
                Pod(kube.get_pod(namespace, pod_name)).annotations.get(annotation))
            if current is not None and current >= queued:
                logger.info("write-behind: %s on %s/%s lost CAS (current counter %d >= "
                            "queued %d); dropping", annotation, namespace, pod_name, current,
                            queued)
                return "lost-cas"
        kube.patch_pod(namespace, pod_name, {"metadata": {"annotations": {annotation: payload}}})
        return "applied"

    # --- views ---

    def has_pending(self, namespace: str, pod: str, annotation: str) -> bool:
        with self._lock:
            return any((r["namespace"], r["pod"], r["annotation"]) == (namespace, pod, annotation)
                       for r in self._pending.values())

    def pending(self) -> list[dict]:
        with self._lock:
            return [dict(self._pending[s]) for s in sorted(self._pending)]

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def stats(self) -> dict:
        with self._lock:
            oldest = min((r["queued_at"] for r in self._pending.values()), default=None)
            return {"pending": len(self._pending),
                    "oldestQueuedAgeS": round(time.time() - oldest, 3)
                    if oldest is not None else None,
                    "closed": dict(self._closed_counts),
                    "durable": bool(self.path)}

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    # --- compaction (the caller holds the lock) ---

    def _maybe_compact_locked(self) -> None:
        if self._fd is None:
            return
        try:
            size = os.fstat(self._fd).st_size
        except OSError:
            return
        if size <= self.max_bytes:
            return
        tmp = self.path + ".compact"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            os.write(fd, "".join(json.dumps(self._pending[s], separators=(",", ":")) + "\n"
                                 for s in sorted(self._pending)).encode())
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, self.path)
        _fsync_dir(self.directory)
        old_fd = self._fd
        self._fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600)
        os.close(old_fd)
        logger.info("write-behind %s compacted (%d pending)", self.path, len(self._pending))
