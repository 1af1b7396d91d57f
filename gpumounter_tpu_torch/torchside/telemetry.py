"""Tenant-side telemetry SDK: what the TENANT experienced.

The control plane's observability measures its own view of mounts, heals
and migrations; this module measures what the training or serving loop
felt. Its snapshots are the control plane's tenant schema, so the worker's
ops port (POST /tenant-telemetry) takes them as they are:

    tel = TenantTelemetry(tenant="team-a/trainer", namespace="default",
                          pod="trainer",
                          publish_url="http://127.0.0.1:9400")
    tel.start_publisher()
    watch_migration(kube, ns, pod,
                    on_quiesce=tel.migration_quiesce(my_quiesce),
                    on_resume=tel.migration_resume(my_resume))
    threading.Thread(target=watch_chip_replacements,
                     args=(kube, ns, pod, tel.heal(my_heal))).start()
    for batch in loader:
        with tel.step(tokens=batch.tokens, queue_depth=loader.depth()):
            loss = train_step(batch)

It records, with one lock acquisition per step (O(1), no allocation on
the hot path beyond a histogram bump):

  * step latency (fixed-bucket histogram), tokens/sec, queue depth —
    the feedback signal the control plane's autoscaler reads;
  * **disruption windows**: intervals during which the tenant was not
    making progress, each attributed to a cause. Windows open from the
    control-plane signals the tenant's hooks deliver — the migration
    quiesce signal (torchside/migrate.py), the chip-replaced heal marker
    (torchside/heal.py), and the generic tpumounter.io/disruption marker
    (evacuation / fence, watch_disruptions below) — and each carries
    the control-plane **trace id** stamped into those annotations, so a
    window joins `/trace/<id>` and the audit trail. Gaps nothing
    signalled (a wedged input pipeline, a stuck collective) surface as
    cause="stall" windows via step-timing: an idle gap longer than
    max(stall_min_s, stall_factor x smoothed step time).
  * disruption-free minutes: each completed wall minute is counted, and
    counted disrupted when any window overlapped it — the numerator of
    the "99.9% disruption-free minutes" tenant SLO.

Window closure: an explicit close signal wins (the resume signal for a
migration, the heal callback returning); any window still open when a
step COMPLETES is closed at that step's start — a finished step is
proof the tenant was already making progress. Open windows never leak:
the chaos harness's invariant 13 asserts none survive a terminal
migration/heal.

Snapshots are cumulative (counters since SDK start) and published to
the local worker's ops port (POST /tenant-telemetry, mutate scope); the
control plane merges them fleet-wide and renders the per-tenant
disruption ledger (`GET /tenants`, `tpumounter tenants`). Stdlib-only by
design — this rides inside the tenant's PyTorch process.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
import urllib.request
from collections import deque
from collections.abc import Callable

from gpumounter_tpu_torch.torchside._kube import is_not_found, pod_annotations, watch_pod

logger = logging.getLogger(__name__)

TENANT_SCHEMA = "tpumounter-tenant/1"

#: stamped by control-plane actors (the recovery controller on
#: evacuation; operators by hand for ad-hoc maintenance) on tenant pods
#: whose chips were disrupted outside the migration/heal choreographies.
#: Payload: {"seq": N, "cause": "evacuation"|"fence"|..., "trace_id":
#: ..., "node": ..., "at": ...}. The control plane stamps this name: it
#: must match it.
ANNOT_DISRUPTION = "tpumounter.io/disruption"

CAUSE_MIGRATION = "migration"
CAUSE_HEAL = "heal"
CAUSE_EVACUATION = "evacuation"
CAUSE_FENCE = "fence"
CAUSE_STALL = "stall"

#: causes delivered by a control-plane signal — their windows must
#: carry the signal's trace id.
SIGNALLED_CAUSES = frozenset(
    {CAUSE_MIGRATION, CAUSE_HEAL, CAUSE_EVACUATION, CAUSE_FENCE})

#: step-latency buckets: training/serving steps live in the ms..s
#: range, well below the mount-latency layout.
STEP_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0)

#: disruption-duration buckets: the tenant-downtime SLO quantiles
#: (p50/p95 tenant-visible migration downtime) come from these.
DOWNTIME_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                    60.0, 120.0, 300.0)

#: completed windows kept in the snapshot ledger (cumulative counters
#: and histograms keep counting past it — the ledger is the browsable
#: tail, not the accounting).
WINDOW_HISTORY = 128


def _env_float(name: str, default: float) -> float:
    """The control plane's defaults, from the same environment variables."""
    return float(os.environ.get(name, default))


def _cumulate(buckets: tuple, value: float, counts: list[float]) -> None:
    for i, bound in enumerate(buckets):
        if value <= bound:
            counts[i] += 1
    counts[-1] += 1  # +Inf


class TenantTelemetry:
    """One tenant process's telemetry state. Thread-safe: the step hot
    path, the watcher callbacks, and the publisher all share `_lock`.

    `clock` is the monotonic source (injectable for tests); wall-clock
    stamps in snapshots come from time.time(). `minute_s` shrinks the
    disruption-free-minute accounting period for tests/benches."""

    def __init__(self, tenant: str, namespace: str = "default",
                 pod: str = "", publish_url: str | None = None,
                 token: str | None = None,
                 publish_interval_s: float | None = None,
                 stall_factor: float | None = None,
                 stall_min_s: float | None = None,
                 minute_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        if not tenant:
            raise ValueError("tenant must be a non-empty name")
        self.tenant = tenant
        self.namespace = namespace
        self.pod = pod
        self.publish_url = publish_url
        self.token = token
        self.publish_interval_s = (publish_interval_s
                                   if publish_interval_s is not None
                                   else _env_float("TENANT_PUBLISH_INTERVAL_S", 15.0))
        self.stall_factor = (stall_factor if stall_factor is not None
                             else _env_float("TENANT_STALL_FACTOR", 10.0))
        self.stall_min_s = (stall_min_s if stall_min_s is not None
                            else _env_float("TENANT_STALL_MIN_S", 1.0))
        self.minute_s = minute_s
        self.clock = clock
        self._lock = threading.Lock()
        self._started_mono = clock()
        self._started_wall = time.time()
        # steps
        self._step_count = 0
        self._step_sum_s = 0.0
        self._step_buckets = [0.0] * (len(STEP_BUCKETS) + 1)
        self._step_ewma_s: float | None = None  # smoothed step duration
        self._last_step_end: float | None = None   # monotonic
        self._last_step_wall = 0.0
        self._tokens_total = 0.0
        #: (monotonic, tokens_total) ring for the recent tokens/sec rate
        self._token_marks: deque = deque(maxlen=32)
        self._queue_depth: float | None = None
        # disruption windows
        self._open: dict[str, dict] = {}      # window key -> open window
        self._windows: deque = deque(maxlen=WINDOW_HISTORY)
        self._cause_windows: dict[str, float] = {}
        self._cause_seconds: dict[str, float] = {}
        self._cause_buckets: dict[str, list[float]] = {}
        #: closed [start, end) monotonic intervals inside the current
        #: minute — minute accounting and stall suppression read these.
        self._recent_intervals: deque = deque(maxlen=64)
        # disruption-free minutes: minutes are indexed from SDK start;
        # _disrupted_idx marks indices any window overlapped. Marking is
        # retro-capable — a stall window detected AFTER its minutes were
        # rolled (the publisher's snapshot rolls them mid-stall, before
        # the next step can discover the gap) corrects the counter.
        self._minute_start = self._started_mono
        self._minutes_total = 0
        self._minutes_disrupted = 0
        self._disrupted_idx: set[int] = set()
        # publisher
        self._pub_stop = threading.Event()
        self._pub_thread: threading.Thread | None = None

    # --- the step hot path ---

    @contextlib.contextmanager
    def step(self, tokens: float = 0.0, queue_depth: float | None = None):
        """Wrap one training/serving step; records its latency on exit.
        A raising step is NOT recorded as progress (it closes nothing)."""
        t0 = self.clock()
        yield
        self.record_step(self.clock() - t0, tokens=tokens,
                         queue_depth=queue_depth)

    def record_step(self, duration_s: float, tokens: float = 0.0,
                    queue_depth: float | None = None) -> None:
        """Record one completed step. Closes any still-open disruption
        window at the step's start (a completed step proves recovery),
        and opens a retroactive cause="stall" window when the idle gap
        since the previous step exceeded the stall threshold with no
        signal-attributed window covering it."""
        now = self.clock()
        duration_s = max(0.0, float(duration_s))
        step_start = now - duration_s
        with self._lock:
            self._roll_minutes(now)
            gap_start = self._last_step_end
            self._step_count += 1
            self._step_sum_s += duration_s
            _cumulate(STEP_BUCKETS, duration_s, self._step_buckets)
            self._step_ewma_s = (duration_s if self._step_ewma_s is None
                                 else 0.9 * self._step_ewma_s
                                 + 0.1 * duration_s)
            self._tokens_total += tokens
            self._token_marks.append((now, self._tokens_total))
            if queue_depth is not None:
                self._queue_depth = float(queue_depth)
            # Stall detection on the idle gap [previous step end, this
            # step start] — the step's own runtime is work, not a stall.
            if gap_start is not None:
                gap = step_start - gap_start
                threshold = max(self.stall_min_s,
                                self.stall_factor * (self._step_ewma_s
                                                     or 0.0))
                if gap > threshold and not self._covered(gap_start,
                                                         step_start):
                    self._close_window_locked({
                        "cause": CAUSE_STALL, "trace_id": "",
                        "detail": f"step gap {gap:.3f}s > "
                                  f"threshold {threshold:.3f}s",
                        "opened_mono": gap_start,
                        "opened_wall": self._last_step_wall,
                    }, ended_mono=step_start,
                        ended_wall=time.time() - duration_s)
            # A completed step closes still-open windows at the step's
            # START — the tenant was demonstrably running then. Only a
            # step that ran ENTIRELY after the window opened counts: a
            # step already in flight when the signal landed proves
            # nothing about recovery (closing on it would truncate the
            # window to ~0 before the disruption even started).
            for key in list(self._open):
                if self._open[key]["opened_mono"] < step_start:
                    self._end_locked(key, ended_mono=step_start)
            self._last_step_end = now
            self._last_step_wall = time.time()

    # --- disruption windows ---

    def begin_disruption(self, cause: str, trace_id: str = "",
                         detail: str = "") -> str:
        """Open a window. Idempotent per (cause, detail) key — a
        re-delivered signal re-opens nothing. Returns the window key."""
        key = f"{cause}:{detail}" if detail else cause
        now = self.clock()
        with self._lock:
            self._roll_minutes(now)
            window = self._open.get(key)
            if window is None:
                self._open[key] = {
                    "cause": cause, "trace_id": trace_id or "",
                    "detail": detail, "opened_mono": now,
                    "opened_wall": time.time(),
                }
                self._mark_minutes(now, now)
                logger.info("disruption window opened: %s (trace %s)",
                            key, trace_id or "-")
            elif trace_id and not window["trace_id"]:
                window["trace_id"] = trace_id  # late attribution wins
        return key

    def end_disruption(self, cause_or_key: str) -> float | None:
        """Close the window (exact key, else the oldest open window
        with that cause). Returns its duration, or None if none open."""
        now = self.clock()
        with self._lock:
            self._roll_minutes(now)
            key = cause_or_key
            if key not in self._open:
                key = next((k for k in self._open
                            if self._open[k]["cause"] == cause_or_key),
                           "")
            if not key:
                return None
            return self._end_locked(key, ended_mono=now)

    def attribute(self, cause: str, trace_id: str,
                  detail: str = "") -> None:
        """Late attribution: stamp a trace id onto the matching open
        window (signal raced the stall detector), else open one."""
        self.begin_disruption(cause, trace_id=trace_id, detail=detail)

    def _end_locked(self, key: str, ended_mono: float) -> float:
        window = self._open.pop(key)
        return self._close_window_locked(window, ended_mono=ended_mono,
                                         ended_wall=time.time())

    def _close_window_locked(self, window: dict, ended_mono: float,
                             ended_wall: float) -> float:
        duration = max(0.0, ended_mono - window["opened_mono"])
        cause = window["cause"]
        self._cause_windows[cause] = self._cause_windows.get(cause, 0) + 1
        self._cause_seconds[cause] = \
            self._cause_seconds.get(cause, 0.0) + duration
        buckets = self._cause_buckets.setdefault(
            cause, [0.0] * (len(DOWNTIME_BUCKETS) + 1))
        _cumulate(DOWNTIME_BUCKETS, duration, buckets)
        self._windows.append({
            "cause": cause,
            "trace_id": window["trace_id"],
            "detail": window["detail"],
            "started_at": round(window["opened_wall"], 3),
            "ended_at": round(ended_wall, 3),
            "duration_s": round(duration, 4),
        })
        self._recent_intervals.append((window["opened_mono"], ended_mono))
        self._mark_minutes(window["opened_mono"], ended_mono)
        logger.info("disruption window closed: %s %.3fs (trace %s)",
                    cause, duration, window["trace_id"] or "-")
        return duration

    def _covered(self, start: float, end: float) -> bool:
        """True when a signal-attributed window (open or recently
        closed) overlaps [start, end] — the gap is already accounted."""
        for window in self._open.values():
            if window["opened_mono"] <= end:
                return True
        for a, b in self._recent_intervals:
            if a <= end and b >= start:
                return True
        return False

    # --- disruption-free minutes ---

    def _minute_idx(self, t: float) -> int:
        return max(0, int((t - self._started_mono) // self.minute_s))

    def _mark_minutes(self, start: float, end: float) -> None:
        """Mark every minute the interval [start, end] touches as
        disrupted. Retro-capable: an index whose minute was ALREADY
        rolled (as clean — a stall only becomes known at the next
        completed step, after the publisher's snapshots rolled the
        stalled minutes) corrects the counter in place. Caller holds
        the lock."""
        # an end exactly on a boundary does not touch the next minute
        last_t = max(start, end - 1e-9)
        for idx in range(self._minute_idx(start),
                         self._minute_idx(last_t) + 1):
            if idx in self._disrupted_idx:
                continue
            self._disrupted_idx.add(idx)
            if idx < self._minutes_total:
                self._minutes_disrupted += 1  # retro correction
        if len(self._disrupted_idx) > 4096:
            # bound memory on perpetual disruption; only indices near
            # the roll frontier can still matter for retro dedup
            frontier = self._minutes_total - 64
            self._disrupted_idx = {i for i in self._disrupted_idx
                                   if i >= frontier}

    def _roll_minutes(self, now: float) -> None:
        """Account every completed minute since the last roll: a minute
        is disrupted when any window overlapped it (open windows mark
        up to the rolling boundary). Caller holds the lock."""
        while now - self._minute_start >= self.minute_s:
            boundary = self._minute_start + self.minute_s
            for window in self._open.values():
                if window["opened_mono"] < boundary:
                    self._mark_minutes(window["opened_mono"], boundary)
            disrupted = self._minutes_total in self._disrupted_idx
            self._minutes_total += 1
            self._minutes_disrupted += 1 if disrupted else 0
            self._minute_start = boundary

    # --- hook adapters (the torchside watchers deliver here) ---

    def migration_quiesce(self, callback: Callable[[dict], None] | None
                          = None) -> Callable[[dict], None]:
        """Wrap watch_migration's on_quiesce: opens the migration window
        (trace id from the signal the orchestrator stamped), then runs
        the tenant's pack callback. The callback raising propagates —
        the watcher retries delivery, and re-opening is idempotent."""
        def _on_quiesce(signal: dict) -> None:
            self.begin_disruption(
                CAUSE_MIGRATION, trace_id=str(signal.get("trace_id", "")),
                detail=str(signal.get("id", "")))
            if callback is not None:
                callback(signal)
        return _on_quiesce

    def migration_resume(self, callback: Callable[[dict], None] | None
                         = None) -> Callable[[dict], None]:
        """Wrap on_resume: runs the tenant's restore callback, THEN
        closes the migration window — downtime ends when the restore
        finished, not when the signal arrived."""
        def _on_resume(signal: dict) -> None:
            # Attribute first: on the migration DESTINATION (or a
            # rollback) the resume signal may be the first this process
            # hears of the migration.
            self.begin_disruption(
                CAUSE_MIGRATION, trace_id=str(signal.get("trace_id", "")),
                detail=str(signal.get("id", "")))
            if callback is not None:
                callback(signal)
            self.end_disruption(
                f"{CAUSE_MIGRATION}:{signal.get('id', '')}"
                if signal.get("id") else CAUSE_MIGRATION)
        return _on_resume

    def heal(self, callback: Callable[[dict], None] | None = None
             ) -> Callable[[dict], None]:
        """Wrap watch_chip_replacements' on_replace: the window spans
        the tenant's repack/restore (the callback), attributed to the
        heal marker's trace id."""
        def _on_replace(marker: dict) -> None:
            key = self.begin_disruption(
                CAUSE_HEAL, trace_id=str(marker.get("trace_id", "")),
                detail=f"generation {marker.get('generation', '?')}")
            try:
                if callback is not None:
                    callback(marker)
            finally:
                self.end_disruption(key)
        return _on_replace

    def external_disruption(self, marker: dict) -> None:
        """watch_disruptions' delivery target: opens a window for the
        stamped cause (evacuation, fence, ...). No explicit close signal
        exists for these — the next completed step closes it."""
        self.begin_disruption(
            str(marker.get("cause") or "external"),
            trace_id=str(marker.get("trace_id", "")),
            detail=str(marker.get("node", "") or marker.get("detail", "")))

    # --- snapshots + publishing ---

    def snapshot(self) -> dict:
        """Cumulative snapshot — the POST /tenant-telemetry body. All
        counters are absolute since SDK start, so the worker/fleet side
        can re-read freely without double counting (the same contract
        worker_telemetry_snapshot keeps)."""
        now = self.clock()
        with self._lock:
            self._roll_minutes(now)
            rate = 0.0
            if len(self._token_marks) >= 2:
                (t0, v0), (t1, v1) = (self._token_marks[0],
                                      self._token_marks[-1])
                if t1 > t0:
                    rate = (v1 - v0) / (t1 - t0)
            return {
                "schema": TENANT_SCHEMA,
                "tenant": self.tenant,
                "namespace": self.namespace,
                "pod": self.pod,
                "at": round(time.time(), 3),
                "started_at": round(self._started_wall, 3),
                "steps": {
                    "count": self._step_count,
                    "sum_s": round(self._step_sum_s, 6),
                    "buckets": [[b, self._step_buckets[i]]
                                for i, b in enumerate(STEP_BUCKETS)],
                    "last_at": round(self._last_step_wall, 3),
                },
                "tokens_total": self._tokens_total,
                "tokens_per_s": round(rate, 3),
                "queue_depth": self._queue_depth,
                "disruption": {
                    "open": [{
                        "cause": w["cause"], "trace_id": w["trace_id"],
                        "detail": w["detail"],
                        "started_at": round(w["opened_wall"], 3),
                        "age_s": round(now - w["opened_mono"], 3),
                    } for w in self._open.values()],
                    "windows": list(self._windows),
                    "by_cause": {
                        cause: {
                            "windows": self._cause_windows.get(cause, 0),
                            "seconds": round(
                                self._cause_seconds.get(cause, 0.0), 4),
                            "buckets": [
                                [b, counts[i]] for i, b in
                                enumerate(DOWNTIME_BUCKETS)],
                        }
                        for cause, counts in
                        sorted(self._cause_buckets.items())},
                    "total_windows": sum(self._cause_windows.values()),
                    "total_seconds": round(
                        sum(self._cause_seconds.values()), 4),
                },
                "minutes": {"total": self._minutes_total,
                            "disrupted": self._minutes_disrupted},
            }

    def publish(self, url: str | None = None, timeout_s: float = 5.0
                ) -> bool:
        """POST the snapshot to the worker ops port. Best-effort: a
        down worker must never take the training loop with it."""
        target = (url or self.publish_url or "").rstrip("/")
        if not target:
            return False
        body = json.dumps(self.snapshot()).encode()
        req = urllib.request.Request(
            target + "/tenant-telemetry", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return 200 <= resp.status < 300
        except Exception as exc:  # noqa: BLE001 — telemetry is advisory
            logger.warning("tenant telemetry publish to %s failed: %s",
                           target, exc)
            return False

    def start_publisher(self) -> "TenantTelemetry":
        with self._lock:
            if self._pub_thread is None:
                self._pub_stop.clear()
                self._pub_thread = threading.Thread(
                    target=self._publish_loop,
                    name=f"tenant-telemetry-{self.tenant}", daemon=True)
                self._pub_thread.start()
        return self

    def stop_publisher(self, final_publish: bool = True) -> None:
        self._pub_stop.set()
        thread = self._pub_thread
        if thread is not None:
            thread.join(timeout=5.0)
        self._pub_thread = None
        if final_publish:
            self.publish()

    def _publish_loop(self) -> None:
        while not self._pub_stop.wait(self.publish_interval_s):
            self.publish()


def disruption_marker(annotations: dict[str, str]) -> dict | None:
    """Parse the generic disruption marker ({seq, cause, trace_id, ...})
    or None — the tolerant-annotation contract heal/migrate follow."""
    raw = annotations.get(ANNOT_DISRUPTION)
    if not raw:
        return None
    try:
        marker = json.loads(raw)
    except ValueError:
        logger.warning("unparseable %s annotation: %r", ANNOT_DISRUPTION,
                       raw)
        return None
    return marker if isinstance(marker, dict) else None


def watch_disruptions(kube, namespace: str, pod_name: str,
                      on_disruption: Callable[[dict], None],
                      stop: threading.Event | None = None,
                      watch_timeout_s: float = 30.0) -> None:
    """Blocking loop mirroring watch_chip_replacements: invoke
    on_disruption(marker) every time the disruption marker's `seq`
    advances. The marker present at start is the baseline — a restarted
    tenant already lived through it."""
    stop = stop or threading.Event()
    try:
        pod = kube.get_pod(namespace, pod_name)
    except Exception as exc:
        if not is_not_found(exc):
            raise
        logger.warning("pod %s/%s not found; nothing to watch",
                       namespace, pod_name)
        return
    baseline = disruption_marker(pod_annotations(pod))
    state = {"seq": int(baseline.get("seq", 0)) if baseline else 0}

    def _deliver(annots: dict[str, str]) -> None:
        marker = disruption_marker(annots)
        if marker is None:
            return
        seq = int(marker.get("seq", 0))
        if seq > state["seq"]:
            state["seq"] = seq
            logger.info("disruption marker observed (seq %d): %s", seq,
                        marker)
            on_disruption(marker)

    watch_pod(kube, namespace, pod_name, _deliver, stop, watch_timeout_s,
              "disruption")
