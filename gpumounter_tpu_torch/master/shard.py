"""Sharded masters: consistent-hash node ownership and a lease a shard.

The counterpart of ``gpumounter_tpu/master/shard.py``. The original
GPUMounter has one master, and every mount goes through it. Here node
ownership is split over N shards:

  * ``HashRing`` maps every node name to exactly one shard by consistent
    hashing (64 virtual nodes a shard keep the split even; growing the ring
    moves about 1/N of the nodes). The mapping is the reference's, hash for
    hash: replicas of both packages route a node alike;
  * each shard has at most one leader at a time, elected through a
    coordination.k8s.io/v1 Lease (``tpumounter-shard-<i>``) as
    kube-controller-manager elects: claim by a CAS create or replace, renew
    before the TTL, take over only once the holder's lease has expired. The
    fake client does the same resourceVersion CAS, so one owner a shard is
    provable in tests (chaos invariant 9);
  * a replica asked about a node it does not own answers 307 to the owner's
    advertised URL (single-target routes) or proxies the sub-batch (the
    batch), so a client needs no shard map;
  * each claim of a shard takes a fencing epoch, the lease's
    leaseTransitions + 1, which the master stamps on every worker call of
    the shard's nodes (``epoch_kwargs``); a worker refuses an older one.

Single owner: a leader counts itself the owner only while
``monotonic() < last renew + duration`` (measured from BEFORE the renew's
write), and a challenger may claim only after it has OBSERVED the lease's
renewTime unchanged for a whole duration on its own monotonic clock (the
client-go discipline: never the holder's wall-clock stamp against ours, so
clock skew cannot shorten a lease). The holder's renew lands no later than
the moment the challenger's window starts, so the holder gives up its claim
before any challenger may take it, and the CAS orders challengers racing
each other.
"""

from __future__ import annotations

import bisect
import hashlib
import socket
import threading
import time
from datetime import datetime, timezone

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.client import KubeClient
from gpumounter_tpu_torch.k8s.errors import (
    ApiError,
    ConflictError,
    NotFoundError,
    classify_exception,
)
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("master.shard")

LEASE_PREFIX = "tpumounter-shard"

SHARDS_OWNED = REGISTRY.gauge(
    "tpumounter_shards_owned",
    "Shards this master replica currently holds the lease for")
SHARD_TAKEOVERS = REGISTRY.counter(
    "tpumounter_shard_takeovers_total",
    "Shard leases acquired by this replica (initial claims included)")
SHARD_RENEW_FAILURES = REGISTRY.counter(
    "tpumounter_shard_renew_failures_total",
    "Lease renew attempts that failed (conflict = lost the lease)")


class HashRing:
    """Consistent hash: node name -> shard index, stable under growth."""

    def __init__(self, shard_count: int, vnodes: int = 64):
        self.shard_count = max(1, int(shard_count))
        points: list[tuple[int, int]] = []
        for shard in range(self.shard_count):
            for v in range(vnodes):
                points.append((self._hash(f"shard-{shard}-vnode-{v}"),
                               shard))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._shards = [s for _, s in points]

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.sha1(key.encode()).digest()[:8], "big")

    def owner_of(self, node_name: str) -> int:
        if self.shard_count == 1:
            return 0
        idx = bisect.bisect(self._hashes, self._hash(node_name))
        if idx == len(self._hashes):
            idx = 0
        return self._shards[idx]


def _now_rfc3339() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def epoch_kwargs(shards: "ShardManager | None", node_name: str) -> dict:
    """Client kwargs carrying `node_name`'s fencing epoch for a mutating
    worker RPC — the one place the stamping rule lives. Empty when no
    shard manager is wired, sharding is inactive, or the shard is
    unowned (epoch 0 never fences, and omitting the kwarg entirely
    keeps legacy client shapes and test doubles working)."""
    if shards is None or not node_name:
        return {}
    epoch = shards.node_epoch(node_name)
    return {"epoch": epoch} if epoch else {}


class ShardManager:
    """One replica's view of shard ownership.

    Inactive until start() (or a manual acquire_once()): the default
    single-master deployment never touches a lease and owns every node
    — exactly the pre-shard behavior, at zero cost on the mount path.
    """

    def __init__(self, kube: KubeClient, cfg=None,
                 replica_id: str | None = None,
                 advertise_url: str | None = None,
                 shard_count: int | None = None,
                 preferred: set[int] | None = None):
        self.kube = kube
        self.cfg = cfg or Config()
        self.shard_count = (shard_count if shard_count is not None
                            else self.cfg.shard_count)
        self.ring = HashRing(self.shard_count)
        self.replica_id = (replica_id or self.cfg.replica_id
                           or socket.gethostname())
        self.advertise_url = (advertise_url
                              if advertise_url is not None
                              else self.cfg.advertise_url)
        self.lease_namespace = (self.cfg.shard_lease_namespace
                                or self.cfg.worker_namespace)
        self.duration_s = self.cfg.shard_lease_duration_s
        self.renew_interval_s = (self.cfg.shard_renew_interval_s
                                 or self.duration_s / 3.0)
        self.preferred = (preferred if preferred is not None
                          else self._parse_preferred())
        #: called with the set of newly-acquired shard indices after an
        #: acquire pass that won any (the re-drive of a dead peer's
        #: migrations and intents comes with the migration machine).
        self.on_takeover = None
        self._lock = threading.Lock()
        #: shard -> monotonic stamp taken BEFORE the successful
        #: acquire/renew write: ownership self-expires duration_s later.
        self._held: dict[int, float] = {}
        #: shard -> fencing epoch (leaseTransitions + 1 at acquire):
        #: monotonic per shard because transitions only ever grows, and
        #: bumped exactly on takeover — the property workers fence on
        #: (worker/server.py refuses an older non-zero epoch FENCED).
        self._epochs: dict[int, int] = {}
        #: shard -> (holder replica id, advertised url, local expiry)
        self._peers: dict[int, tuple[str, str, float]] = {}
        #: shard -> (last seen renewTime string, monotonic observed-at):
        #: expiry is "renewTime unchanged for duration_s of OUR clock",
        #: never a cross-replica wall-clock comparison.
        self._observed: dict[int, tuple[str, float]] = {}
        self._started = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # --- preference parsing ---

    def _parse_preferred(self) -> set[int] | None:
        raw = (self.cfg.shard_preferred or "").strip()
        if not raw:
            return None  # volunteer for any never-held shard
        if raw == "auto":
            # StatefulSet pod names end in "-<ordinal>": replica i
            # volunteers for shard i % count. No ordinal = greedy.
            tail = self.replica_id.rsplit("-", 1)[-1]
            if tail.isdigit():
                return {int(tail) % self.shard_count}
            return None
        out = set()
        for part in raw.split(","):
            part = part.strip()
            if part.isdigit():
                out.add(int(part) % self.shard_count)
        return out or None

    # --- ownership reads (the request hot path) ---

    def active(self) -> bool:
        return self._started

    def owner_shard(self, node_name: str) -> int:
        return self.ring.owner_of(node_name)

    def owned_shards(self) -> set[int]:
        now = time.monotonic()
        with self._lock:
            return {s for s, stamp in self._held.items()
                    if now - stamp < self.duration_s}

    def owns_node(self, node_name: str) -> bool:
        if not self._started:
            return True  # unsharded master: everything is local
        return self.ring.owner_of(node_name) in self.owned_shards()

    def node_epoch(self, node_name: str) -> int:
        """The fencing epoch to stamp on mutating RPCs for this node:
        leaseTransitions+1 of its shard's lease as of OUR LAST
        acquisition — deliberately NOT gated on still holding the
        shard. A replica that lost the lease mid-operation must keep
        stamping its (now stale) epoch so the worker FENCES the write;
        degrading to 0 here would turn "stale owner" into "unfenced
        legacy traffic" the worker accepts — reopening the split-brain
        window fencing exists to close. 0 only when sharding is
        inactive or we never held the shard (a replica the shard gate
        never routed mutations to)."""
        if not self._started:
            return 0
        with self._lock:
            return self._epochs.get(self.ring.owner_of(node_name), 0)

    def route(self, node_name: str) -> tuple[str, str | None]:
        """("local", None) when this replica owns the node's shard,
        ("remote", url) when a live peer does, ("unowned", None) when
        the shard's lease is expired/unheld (caller answers 503 and the
        renew loop — ours or a peer's — takes it over)."""
        if not self._started:
            return "local", None
        shard = self.ring.owner_of(node_name)
        if shard in self.owned_shards():
            return "local", None
        now = time.monotonic()
        with self._lock:
            peer = self._peers.get(shard)
        if peer is not None and peer[2] > now and peer[1]:
            return "remote", peer[1]
        return "unowned", None

    def table(self) -> dict:
        """The shard table served at GET /shards."""
        owned = self.owned_shards()
        now = time.monotonic()
        with self._lock:
            peers = dict(self._peers)
        shards = []
        for i in range(self.shard_count):
            entry: dict = {"shard": i, "lease": f"{LEASE_PREFIX}-{i}"}
            if i in owned:
                entry["holder"] = self.replica_id
                entry["url"] = self.advertise_url
                entry["local"] = True
                with self._lock:
                    entry["epoch"] = self._epochs.get(i, 0)
            elif i in peers and peers[i][2] > now:
                entry["holder"], entry["url"], _ = peers[i]
                entry["local"] = False
            else:
                entry["holder"] = None
                entry["local"] = False
            shards.append(entry)
        return {"replica": self.replica_id, "shardCount": self.shard_count,
                "active": self._started, "shards": shards}

    # --- lease machinery ---

    def _lease_spec(self, transitions: int) -> dict:
        return {
            "holderIdentity": f"{self.replica_id} {self.advertise_url}",
            "leaseDurationSeconds": int(self.duration_s),
            "renewTime": _now_rfc3339(),
            "leaseTransitions": transitions,
        }

    @staticmethod
    def _holder_of(lease: dict) -> tuple[str, str]:
        raw = (lease.get("spec", {}).get("holderIdentity") or "")
        holder, _, url = raw.partition(" ")
        return holder, url

    def _expired(self, shard: int, lease: dict) -> bool:
        """Expired = the renewTime field has not CHANGED for a full
        lease duration measured on OUR monotonic clock (client-go
        leader-election semantics). A holder whose clock is skewed
        relative to ours still gets its full duration; only a holder
        that actually stopped writing renews loses the lease."""
        spec = lease.get("spec", {})
        if not spec.get("holderIdentity"):
            self._observed.pop(shard, None)
            return True  # released
        renew_raw = spec.get("renewTime") or ""
        if not renew_raw:
            return True
        duration = float(spec.get("leaseDurationSeconds")
                         or self.duration_s)
        now = time.monotonic()
        with self._lock:
            seen = self._observed.get(shard)
            if seen is None or seen[0] != renew_raw:
                # Fresh renew observed: the unchanged-window restarts.
                self._observed[shard] = (renew_raw, now)
                return False
            return now - seen[1] > duration

    def acquire_once(self) -> set[int]:
        """One acquire/renew pass over every shard lease; returns the
        newly-acquired shard set. Never raises: API failures leave the
        shard for the next pass (held shards self-expire regardless)."""
        newly: set[int] = set()
        for shard in range(self.shard_count):
            try:
                self._acquire_shard(shard, newly)
            except Exception as exc:  # noqa: BLE001 — keep the pass going
                logger.warning("shard %d lease pass failed: %s", shard, exc)
        SHARDS_OWNED.set(float(len(self.owned_shards())))
        if newly:
            SHARD_TAKEOVERS.inc(float(len(newly)))
            logger.info("replica %s acquired shard(s) %s",
                        self.replica_id, sorted(newly))
            callback = self.on_takeover
            if callback is not None:
                # Off-thread: the callback (a re-drive scans the cluster) can outlast a renew
                # interval, and blocking THIS thread would stop renews —
                # the replica could lose its own leases mid-takeover.
                threading.Thread(
                    target=self._fire_takeover,
                    args=(callback, set(newly)),
                    name="shard-takeover", daemon=True).start()
        return newly

    @staticmethod
    def _fire_takeover(callback, newly: set[int]) -> None:
        try:
            callback(newly)
        except Exception:  # noqa: BLE001 — re-drive is best-effort
            logger.exception("on_takeover callback failed")

    def _acquire_shard(self, shard: int, newly: set[int]) -> None:
        name = f"{LEASE_PREFIX}-{shard}"
        # Stamp BEFORE the write: if the write succeeds, ownership began
        # no later than this instant, so self-expiry is conservative.
        stamp = time.monotonic()
        try:
            lease = self.kube.get_lease(self.lease_namespace, name)
        except NotFoundError:
            if not self._may_claim_fresh(shard):
                return
            manifest = {
                "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                "metadata": {"name": name,
                             "namespace": self.lease_namespace},
                "spec": self._lease_spec(transitions=0),
            }
            try:
                self.kube.create_lease(self.lease_namespace, manifest)
            except (ConflictError, ApiError):
                return  # lost the race; next pass sees the winner
            self._record_held(shard, stamp, newly, transitions=0)
            return
        holder, url = self._holder_of(lease)
        transitions = int(lease.get("spec", {}).get("leaseTransitions")
                          or 0)
        if holder == self.replica_id:
            # Renew: CAS replace; a conflict means another writer beat
            # us — treat the lease as lost until proven otherwise.
            lease["spec"] = self._lease_spec(transitions)
            try:
                self.kube.update_lease(self.lease_namespace, name, lease)
            except (ConflictError, ApiError) as exc:
                SHARD_RENEW_FAILURES.inc()
                logger.warning("shard %d renew failed (%s); dropping "
                               "local claim", shard, exc)
                with self._lock:
                    self._held.pop(shard, None)
                return
            self._record_held(shard, stamp, newly, transitions=transitions)
            return
        if self._expired(shard, lease):
            lease["spec"] = self._lease_spec(transitions + 1)
            try:
                self.kube.update_lease(self.lease_namespace, name, lease)
            except (ConflictError, ApiError):
                return  # another challenger won; next pass records it
            self._record_held(shard, stamp, newly,
                              transitions=transitions + 1)
            return
        # Held by a live peer: remember where to redirect until its
        # lease would expire on OUR clock (same local-observation basis
        # as _expired — never the peer's wall stamp).
        duration = float(lease["spec"].get("leaseDurationSeconds")
                         or self.duration_s)
        with self._lock:
            self._held.pop(shard, None)
            self._peers[shard] = (holder, url,
                                  time.monotonic() + duration)

    def _may_claim_fresh(self, shard: int) -> bool:
        return self.preferred is None or shard in self.preferred

    def _record_held(self, shard: int, stamp: float,
                     newly: set[int], transitions: int = 0) -> None:
        with self._lock:
            if shard not in self._held:
                newly.add(shard)
            self._held[shard] = stamp
            # Fencing epoch = the transitions value WE wrote, + 1 (so a
            # fresh create is epoch 1 > 0 = the unfenced sentinel).
            # Monotonic: transitions only grows, and a renew keeps it.
            self._epochs[shard] = max(self._epochs.get(shard, 0),
                                      int(transitions) + 1)
            self._peers.pop(shard, None)

    # --- lifecycle ---

    def start(self) -> "ShardManager":
        self._started = True
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="shard-lease-renew",
                                            daemon=True)
            self._thread.start()
        return self

    def start_without_loop(self) -> "ShardManager":
        """Activate lease-based ownership with no background thread:
        the caller drives acquire_once() (tests, and entry.py's checks)."""
        self._started = True
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.acquire_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("shard lease pass crashed")
            self._stop.wait(self.renew_interval_s)

    def stop(self, release: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if release:
            self.release_all()

    def release_all(self) -> None:
        """Graceful handoff: blank our holder identity so peers can
        claim immediately instead of waiting out the TTL."""
        with self._lock:
            held = list(self._held)
            self._held.clear()
        SHARDS_OWNED.set(0.0)
        for shard in held:
            name = f"{LEASE_PREFIX}-{shard}"
            try:
                lease = self.kube.get_lease(self.lease_namespace, name)
                holder, _ = self._holder_of(lease)
                if holder != self.replica_id:
                    continue
                lease["spec"]["holderIdentity"] = ""
                self.kube.update_lease(self.lease_namespace, name, lease)
            except Exception as exc:  # noqa: BLE001 — TTL covers us
                logger.warning("shard %d release failed (%s); peers "
                               "take over at lease expiry", shard,
                               classify_exception(exc))
