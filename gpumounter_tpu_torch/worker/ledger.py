"""The worker's mount ledger: an fsync'd append-only JSONL journal.

The counterpart of ``gpumounter_tpu/worker/ledger.py``. A hot mount grants
GPUs behind the kubelet's back, so nobody but this worker can clean up after
its death: a worker that dies in the middle of a mount strands cgroup grants,
injected ``/dev/nvidiaN`` nodes and slave-pod bookings. Every mutating batch
therefore appends an intent record before its first side effect and a done
record after its last, each fsync'd. A death at any point leaves nothing, or
an open transaction that names the GPUs, paths, cgroups and bookings in
flight, which the restart's replay (``worker/resync.py``) converges against
what the host and the books show.

Record kinds, one JSON object a line (the reference's keys, so that a
journal of either package reads line by line against the other's with ids
and times masked):

  txn           {"kind":"txn","txn":id,"op":"mount"|"unmount", the target's
                namespace/pod/pod_uid, target, dev_dir, ns_pid, cgroup_dirs,
                "chips":[{uuid,rel_path,major,minor,slave[,share]}],"at":ts}
  done          {"kind":"done","txn":id,"outcome":...,"at":ts}; outcomes:
                success, rolled-back, error, busy, replayed-completed,
                replayed-rolled-back, replayed-unmounted
  epoch         {"kind":"epoch","epoch":N}: the highest fencing epoch this
                worker has accepted (``worker/server.py``)
  release       {"kind":"release","rel":id,"namespace":ns,"pods":[...]}:
                slave pods whose delete failed after an unmount, queued and
                retried (the next release, ``retry_pending_releases`` and
                the restart's replay) instead of leaked
  release_done  {"kind":"release_done","rel":id}: every pod of it is gone
  snapshot      {"kind":"snapshot","holdings":[...]}: written by compaction
  shutdown      {"kind":"shutdown"}: the clean close of the SIGTERM drain;
                a non-empty ledger without it means the last process died

A GPU's ``rel_path`` is its node's name under /dev (``nvidia0``). The file
is compacted (a temporary file, fsync'd, then renamed over it) once it grows
past ``ledger_max_bytes``: the rewrite keeps the net holdings as a snapshot,
every open transaction, every pending release and the epoch. One lock
guards append and fsync; the mounter's batches, the server's epoch checks
and the drain reach it from any gRPC thread.
"""

from __future__ import annotations

import json
import os
import secrets
import time

from gpumounter_tpu_torch.utils.jsonl import fsync_dir as _fsync_dir
from gpumounter_tpu_torch.utils.jsonl import read_records
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("worker.ledger")

LEDGER_FILE = "ledger.jsonl"

LEDGER_APPENDS = REGISTRY.counter(
    "tpumounter_ledger_appends_total",
    "Ledger records appended (fsync'd), by record kind")
LEDGER_OPEN_TXNS = REGISTRY.gauge(
    "tpumounter_ledger_open_transactions",
    "Mutating batches intent-logged but not yet closed")
LEDGER_COMPACTIONS = REGISTRY.counter(
    "tpumounter_ledger_compactions_total",
    "Ledger rotations (rewrite to snapshot + open txns + epoch)")


class LedgerError(RuntimeError):
    pass


def _chip_record(dev, policy=None) -> dict:
    """A GPU as a txn names it. A fractional grant carries its policy, so
    that the replay re-arms it at the same weight and budget; a whole-GPU
    grant has no share key."""
    record = {"uuid": dev.uuid, "rel_path": dev.basename, "major": dev.major,
              "minor": dev.minor, "slave": dev.pod_name or ""}
    if policy and dev.uuid in policy:
        weight, rate_budget = policy[dev.uuid]
        record["share"] = {"weight": int(weight), "rate_budget": int(rate_budget)}
    return record


class MountLedger:
    """One worker's durable mount journal (see the module's docstring)."""

    def __init__(self, directory: str, max_bytes: int = 4 * 1024 * 1024):
        self.directory = directory
        self.path = os.path.join(directory, LEDGER_FILE)
        self.max_bytes = max(4096, int(max_bytes))
        self._lock = OrderedLock("worker.ledger")
        self._open_txns: dict[str, dict] = {}
        #: rel id -> release record: slave-pod deletes deferred by a failure
        self._pending_releases: dict[str, dict] = {}
        #: the net holdings after every closed txn: (namespace, pod) ->
        #: {uuid: chip record}; books == mounts == ledger reads it
        self._holdings: dict[tuple[str, str], dict[str, dict]] = {}
        self._epoch = 0
        self._clean_shutdown = False
        self._fd: int | None = None
        os.makedirs(directory, exist_ok=True)
        created = not os.path.exists(self.path)
        self._load()
        self._fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600)
        if created:
            # the new file's entry, so that a node crash cannot lose the
            # file that the fsync'd appends went into
            _fsync_dir(directory)
        LEDGER_OPEN_TXNS.set(float(len(self._open_txns)))

    # --- load ---

    def _load(self) -> None:
        """The open txns, holdings and epoch from the file. A torn last line
        (a death in the middle of an append) is dropped, and cut off the
        file so that the next append starts a line of its own (the
        reference leaves it, and the next record is lost with it at the
        following reload): intents are written before their side effects,
        so a torn intent's batch never began."""
        if not os.path.exists(self.path):
            return
        records, dropped = read_records(self.path)
        for record in records:
            self._apply(record)
        if dropped:
            logger.warning("ledger %s: dropped %d torn/corrupt line(s)", self.path, dropped)

    def _apply(self, record: dict) -> None:
        kind = record.get("kind")
        if kind == "txn":
            self._open_txns[record["txn"]] = record
            self._clean_shutdown = False
        elif kind == "done":
            txn = self._open_txns.pop(record.get("txn", ""), None)
            if txn is not None:
                self._fold(txn, record.get("outcome", ""))
            self._clean_shutdown = False
        elif kind == "epoch":
            self._epoch = max(self._epoch, int(record.get("epoch", 0)))
        elif kind == "release":
            self._pending_releases[record.get("rel", "")] = record
            self._clean_shutdown = False
        elif kind == "release_done":
            self._pending_releases.pop(record.get("rel", ""), None)
        elif kind == "snapshot":
            self._holdings = {
                (entry.get("namespace", ""), entry.get("pod", "")):
                    {c["uuid"]: c for c in entry.get("chips", [])}
                for entry in record.get("holdings", [])}
        elif kind == "shutdown":
            self._clean_shutdown = True

    def _fold(self, txn: dict, outcome: str) -> None:
        """One closed txn into the net holdings: a mount adds its GPUs on
        success or replayed-completed, an unmount drops them on success or
        replayed-unmounted; any other outcome changes nothing."""
        key = (txn.get("namespace", ""), txn.get("pod", ""))
        chips = {c["uuid"]: c for c in txn.get("chips", [])}
        if txn.get("op") == "mount":
            if outcome in ("success", "replayed-completed"):
                self._holdings.setdefault(key, {}).update(chips)
        elif outcome in ("success", "replayed-unmounted"):
            held = self._holdings.get(key)
            if held:
                for uuid in chips:
                    held.pop(uuid, None)
                if not held:
                    self._holdings.pop(key, None)

    # --- the append protocol ---

    def _append(self, record: dict) -> None:
        if self._fd is None:
            raise LedgerError("ledger is closed")
        os.write(self._fd, (json.dumps(record, separators=(",", ":")) + "\n").encode())
        os.fsync(self._fd)
        if record.get("kind") != "shutdown":
            self._clean_shutdown = False
        LEDGER_APPENDS.inc(kind=record.get("kind", "?"))

    def begin(self, op: str, *, target, devices, pod=None, policy=None) -> str:
        """Log one mutating batch's intent before its first side effect;
        returns the txn id that commit() closes. policy: a GPU's uuid ->
        (weight, rate_budget) for a fractional grant, journaled a GPU."""
        txn_id = f"{op[0]}-{secrets.token_hex(5)}"
        pod_obj = pod or getattr(target, "pod", None)
        record = {
            "kind": "txn", "txn": txn_id, "op": op,
            "namespace": getattr(pod_obj, "namespace", "") if pod_obj else "",
            "pod": getattr(pod_obj, "name", "") if pod_obj else "",
            "pod_uid": getattr(pod_obj, "uid", "") if pod_obj else "",
            "target": getattr(target, "description", str(target)),
            "dev_dir": getattr(target, "dev_dir", ""),
            "ns_pid": getattr(target, "ns_pid", None),
            "cgroup_dirs": list(getattr(target, "cgroup_dirs", []) or []),
            "chips": [_chip_record(d, policy) for d in devices],
            "at": time.time(),
        }
        with self._lock:
            self._append(record)
            self._open_txns[txn_id] = record
            LEDGER_OPEN_TXNS.set(float(len(self._open_txns)))
        return txn_id

    def commit(self, txn_id: str, outcome: str) -> None:
        """Close a txn with its outcome. An unknown id is a no-op: a replay
        may close a txn its caller also closes."""
        with self._lock:
            txn = self._open_txns.pop(txn_id, None)
            if txn is None:
                return
            self._append({"kind": "done", "txn": txn_id, "outcome": outcome,
                          "at": time.time()})
            self._fold(txn, outcome)
            LEDGER_OPEN_TXNS.set(float(len(self._open_txns)))
            self._maybe_compact_locked()

    def record_epoch(self, epoch: int) -> None:
        """Persist the highest fencing epoch seen; written only on an
        increase, so steady traffic costs nothing. The epoch is taken only
        once its record is on disk: an append that raises leaves the old
        one, so that the next call with the same epoch writes it again."""
        epoch = int(epoch)
        with self._lock:
            if epoch <= self._epoch:
                return
            self._append({"kind": "epoch", "epoch": epoch})
            self._epoch = epoch

    def close(self) -> None:
        """The clean close: append the shutdown marker (the drain let every
        batch in flight finish first) and close the fd. Idempotent."""
        with self._lock:
            if self._fd is None:
                return
            try:
                self._append({"kind": "shutdown", "at": time.time()})
            finally:
                os.close(self._fd)
                self._fd = None
                self._clean_shutdown = True

    def abandon(self) -> None:
        """Close the fd without the marker: a process that died (a real
        death just loses the fd). Idempotent."""
        with self._lock:
            if self._fd is None:
                return
            os.close(self._fd)
            self._fd = None

    # --- reads: the replay's and the invariants' ---

    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def open_transactions(self) -> list[dict]:
        """Txns logged and never closed: what the restart's replay converges."""
        with self._lock:
            return [dict(t) for t in self._open_txns.values()]

    def was_clean_shutdown(self) -> bool:
        with self._lock:
            return self._clean_shutdown

    def net_holdings(self) -> dict[tuple[str, str], set[str]]:
        """(namespace, pod) -> the GPU uuids the ledger says are mounted:
        closed successful mounts less closed unmounts."""
        with self._lock:
            return {key: set(chips) for key, chips in self._holdings.items() if chips}

    def share_holdings(self) -> dict[tuple[str, str], dict[str, tuple[int, int]]]:
        """(namespace, pod) -> {uuid: (weight, rate_budget)} for every held
        GPU journaled with a fractional policy: what the replay re-arms."""
        out: dict[tuple[str, str], dict[str, tuple[int, int]]] = {}
        with self._lock:
            for key, chips in self._holdings.items():
                shares = {uuid: (int(c["share"]["weight"]), int(c["share"]["rate_budget"]))
                          for uuid, c in chips.items() if isinstance(c.get("share"), dict)}
                if shares:
                    out[key] = shares
        return out

    def forget_holding(self, namespace: str, pod: str, uuids=None) -> None:
        """Drop holdings the books no longer back (the pod went while the
        worker was down, taking its nodes along, with no unmount txn).
        Appends a closed unmount, so that the correction is durable too."""
        with self._lock:
            held = self._holdings.get((namespace, pod))
            if not held:
                return
            drop = set(held) if uuids is None else set(uuids) & set(held)
            if not drop:
                return
            txn_id = f"u-{secrets.token_hex(5)}"
            record = {
                "kind": "txn", "txn": txn_id, "op": "unmount",
                "namespace": namespace, "pod": pod, "pod_uid": "",
                "target": f"{namespace}/{pod}", "dev_dir": "",
                "ns_pid": None, "cgroup_dirs": [],
                "chips": [held[u] for u in sorted(drop)],
                "at": time.time(),
            }
            self._append(record)
            self._append({"kind": "done", "txn": txn_id, "outcome": "replayed-unmounted",
                          "at": time.time()})
            self._fold(record, "replayed-unmounted")

    # --- deferred slave releases ---

    def queue_release(self, namespace: str, pods: list[str]) -> str:
        """Record slave pods whose delete after an unmount failed: a queue
        entry, retried, in place of a leaked booking. Returns its id."""
        rel_id = f"r-{secrets.token_hex(5)}"
        record = {"kind": "release", "rel": rel_id, "namespace": namespace,
                  "pods": sorted(pods), "at": time.time()}
        with self._lock:
            self._append(record)
            self._pending_releases[rel_id] = record
        return rel_id

    def complete_release(self, rel_id: str) -> None:
        """Close a release entry; an unknown id is a no-op (a replay and a
        live retry may race)."""
        with self._lock:
            if self._pending_releases.pop(rel_id, None) is None:
                return
            self._append({"kind": "release_done", "rel": rel_id, "at": time.time()})
            self._maybe_compact_locked()

    def pending_releases(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._pending_releases.values()]

    # --- compaction ---

    def _maybe_compact_locked(self) -> None:
        try:
            size = os.fstat(self._fd).st_size
        except OSError:
            return
        if size > self.max_bytes:
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Rewrite the journal as snapshot + epoch + open txns + pending
        releases, through a temporary file and a rename: a death in the
        middle leaves the old file or the new one, never a torn one. The
        directory is fsync'd after the rename, so that after a node crash
        its entry names the new file, into which the later appends go."""
        tmp = self.path + ".compact"
        lines = [{"kind": "snapshot",
                  "holdings": [{"namespace": ns, "pod": pod, "chips": list(chips.values())}
                               for (ns, pod), chips in self._holdings.items() if chips],
                  "at": time.time()}]
        if self._epoch:
            lines.append({"kind": "epoch", "epoch": self._epoch})
        lines.extend(self._open_txns.values())
        lines.extend(self._pending_releases.values())
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            os.write(fd, "".join(json.dumps(r, separators=(",", ":")) + "\n"
                                 for r in lines).encode())
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, self.path)
        _fsync_dir(self.directory)
        old_fd = self._fd
        self._fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600)
        if old_fd is not None:
            os.close(old_fd)
        LEDGER_COMPACTIONS.inc()
        logger.info("ledger %s compacted (%d open txn(s), %d pod holding(s))", self.path,
                    len(self._open_txns), len(self._holdings))


def open_ledger(cfg) -> MountLedger | None:
    """The daemons' constructor: a ledger when cfg.ledger_dir is set and
    writable, else None (epochs in memory only, no replay). Never raises:
    an unwritable hostPath must not stop the worker from serving."""
    if not cfg.ledger_dir:
        return None
    try:
        return MountLedger(cfg.ledger_dir, max_bytes=cfg.ledger_max_bytes)
    except OSError as exc:
        logger.warning("ledger unavailable at %s (%s); running without crash-replay",
                       cfg.ledger_dir, exc)
        return None
