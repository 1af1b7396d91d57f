"""The gray-failure health plane: a scorer of each node, a quarantine state
machine, and a canary prober.

The counterpart of ``gpumounter_tpu/health/plane.py``. The recovery
controller (``recovery/``) sees a node as alive or dead; the node that
answers every probe while it mounts fifty times slower or drops a share of
its calls passes its checks for ever, and goes on taking placements. This
plane catches it. Two sources of evidence drive one state machine a node,

    healthy -> suspect -> quarantined -> rehabilitating -> healthy

  * ``HealthPlane.observe``, the passive scorer, runs on every pass of the
    fleet collector (``FleetCollector.health``, exception-isolated): a
    node's mount p95 against the fleet's median (past both multiplier x
    median and median + floor), its mount error ratio, its breaker, and
    the canary's failures; each wants HEALTH_MIN_SAMPLES. It fails open: a
    pass in which fewer than HEALTH_MIN_FRESH_FRACTION of the entries are
    fresh is skipped whole (a broken collector must not quarantine the
    fleet), and a stale entry freezes its node's counters;
  * ``CanaryProber``, the active probe: a real mount -> ProbeGPU -> unmount
    through the whole worker path, into the reserved pod
    <HEALTH_CANARY_POD_PREFIX><node> in HEALTH_CANARY_NAMESPACE, of every
    suspect, quarantined and rehabilitating node, on the fan-out core. A
    node without its canary pod (PodNotFound) is skipped, not failed.

Hysteresis both ways (HEALTH_SUSPECT_STRIKES and HEALTH_QUARANTINE_STRIKES
bad passes in a row to go down, HEALTH_CLEAR_PASSES clean ones back) and a
budget: the scorer quarantines at most HEALTH_QUARANTINE_BUDGET of the fleet
(at least one node); an operator's quarantine (POST /health/quarantine/<node>)
is exempt and leaves only by an operator's release. A quarantined node leaves
after HEALTH_REHAB_CANARY_PASSES canary passes in a row (clean passive passes
when no prober runs), into ``rehabilitating`` (placeable, last), and is
healthy after HEALTH_PROBATION_PASSES clean passes; a bad pass there sends it
straight back. Quarantined and still an outlier for HEALTH_DRAIN_BURN_PASSES,
a node's pane recommends moving its tenants off.

Quarantine is soft: nothing is unmounted. ``excluded_hosts()`` never raises
(it degrades to the empty set); the fleet collector's pull tells the node's
worker to drain its warm pool (CollectTelemetry's ``quarantined``). The
canary rides the mount path's breaker-aware client, so its own failures may
trip the breaker: while a node has canary failures, its ``breaker_open`` is
not counted again. An evacuation supersedes a quarantine (``note_evacuated``)
and ``release`` refuses an evacuated node. The quarantined and
rehabilitating nodes persist through the store (``save_health_state``), and
``load()`` restores them at a master's start or a shard's takeover. Every
transition is a ``health`` record of the flight recorder with its signals
(chaos invariant 20 reads them), and the six series are the reference's.
"""

from __future__ import annotations

import statistics
import threading
import time
from dataclasses import dataclass, field

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.obs.flight import FLIGHT
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.utils.fanout import get_core
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("health.plane")

#: the states, the gauge's only label values (node names ride /health/nodes)
STATES = ("healthy", "suspect", "quarantined", "rehabilitating")

NODE_HEALTH_STATE = REGISTRY.gauge(
    "tpumounter_node_health_state",
    "Nodes per gray-failure health state (healthy / suspect / "
    "quarantined / rehabilitating); node names ride GET /health/nodes")
CANARY_PROBES = REGISTRY.counter(
    "tpumounter_canary_probes_total",
    "Canary mount->verify->unmount probes driven through the full "
    "worker path")
CANARY_FAILURES = REGISTRY.counter(
    "tpumounter_canary_failures_total",
    "Canary probes that failed (mount refused, chip unhealthy, or "
    "transport error)")
QUARANTINE_TRANSITIONS = REGISTRY.counter(
    "tpumounter_quarantine_transitions_total",
    "Health state-machine transitions by (from_state, to_state) — "
    "bounded by the 4-state vocabulary")
SCORER_SKIPS = REGISTRY.counter(
    "tpumounter_health_scorer_skips_total",
    "Whole scoring passes skipped fail-open (collector staleness / "
    "plane disabled)")
BUDGET_DENIALS = REGISTRY.counter(
    "tpumounter_quarantine_budget_denials_total",
    "Automatic quarantine verdicts suppressed by the fleet-wide "
    "quarantine budget")


@dataclass
class _NodeRecord:
    """One node's state and its streaks (passes in a row, not totals)."""

    state: str = "healthy"
    since: float = field(default_factory=time.time)
    reason: str = ""
    signals: list = field(default_factory=list)
    #: bad passes in a row (healthy -> suspect -> quarantined)
    strikes: int = 0
    #: clean passes in a row (suspect -> healthy)
    clear: int = 0
    #: canary passes and failures in a row (the rehab gate, a signal)
    canary_ok: int = 0
    canary_fails: int = 0
    canary_detail: str = ""
    #: clean passes in a row while rehabilitating (probation)
    probation_clear: int = 0
    #: an operator's: exempt from the budget, never rehabilitated by itself
    manual: bool = False
    #: quarantined passes in a row still past the outlier bar, and whether
    #: that recommended moving the tenants off
    slo_burn: int = 0
    drain_recommended: bool = False
    #: superseded by an evacuation
    evacuated: bool = False

    def pane(self) -> dict:
        return {
            "state": self.state,
            "since": round(self.since, 3),
            "reason": self.reason,
            "signals": list(self.signals),
            "strikes": self.strikes,
            "canary": {"consecutive_ok": self.canary_ok,
                       "consecutive_failures": self.canary_fails,
                       "detail": self.canary_detail},
            "manual": self.manual,
            "drain_recommended": self.drain_recommended,
            "evacuated": self.evacuated,
        }


class HealthPlane:
    """The scorer and the state machine: an observer of the collector's
    passes, whose failures never fail telemetry and whose reads never fail
    a consumer."""

    def __init__(self, cfg=None, recovery=None, store=None):
        self.cfg = cfg or Config()
        #: the RecoveryController: release refuses the nodes it evacuated
        self.recovery = recovery
        #: the MasterStore: the quarantine set survives a takeover
        self.store = store
        #: set by the prober's start; without a prober, rehab takes clean
        #: passive passes instead of canary passes
        self.canary_active = False
        self._lock = OrderedLock("health.state")
        self._nodes: dict[str, _NodeRecord] = {}
        #: the last pass's verdict for the pane: "" | "scoring" | "stale"
        self._last_pass = {"at": 0.0, "verdict": "", "fresh": 0, "total": 0,
                           "median_p95_ms": None}

    @property
    def enabled(self) -> bool:
        return bool(self.cfg.health_enabled)

    # --- the passive scorer ---

    def observe(self, nodes: dict[str, dict]) -> None:
        """Score one pass of the fleet collector (its node entries)."""
        if not self.enabled or not nodes:
            return
        failpoints.fire("health.observe", nodes=len(nodes))
        fresh = {n: e for n, e in nodes.items() if not e.get("stale") and not e.get("error")}
        total = len(nodes)
        # fail-open: most of the fleet uncollected is the collector's fault,
        # and scoring the rest against a broken median would be worse
        floor = max(1, int(total * float(self.cfg.health_min_fresh_fraction)))
        if len(fresh) < floor:
            SCORER_SKIPS.inc()
            with self._lock:
                self._last_pass = {"at": time.time(), "verdict": "stale", "fresh": len(fresh),
                                   "total": total, "median_p95_ms": None}
            logger.warning("health scorer skipped pass fail-open: %d/%d nodes fresh (< %d)",
                           len(fresh), total, floor)
            return
        median = self._fleet_median_p95(fresh)
        events: list[dict] = []
        with self._lock:
            self._last_pass = {"at": time.time(), "verdict": "scoring", "fresh": len(fresh),
                               "total": total, "median_p95_ms": median}
            # healthy and suspect records of nodes gone from the fleet go; a
            # quarantined node that restarts is not whole again
            for node in list(self._nodes):
                if node not in nodes and self._nodes[node].state in ("healthy", "suspect"):
                    del self._nodes[node]
            quarantined = sum(1 for r in self._nodes.values() if r.state == "quarantined")
            budget = max(1, int(total * float(self.cfg.health_quarantine_budget)))
            for node in sorted(fresh):
                rec = self._nodes.setdefault(node, _NodeRecord())
                if rec.evacuated:
                    continue  # the recovery plane's verdict won
                signals = self._score(rec, fresh[node], median)
                ev = self._step(node, rec, signals, budget_left=budget - quarantined)
                if ev:
                    events.append(ev)
                    if ev["to"] == "quarantined":
                        quarantined += 1
                    elif ev["from"] == "quarantined":
                        quarantined -= 1
            self._export_gauge_locked()
        # the records and the store outside health.state: both have locks of
        # their own, and nothing here needs the pass's atomicity
        for ev in events:
            self._announce(ev)
        if any(ev["to"] == "quarantined" or ev["from"] == "quarantined" for ev in events):
            self._persist()

    def _fleet_median_p95(self, fresh: dict[str, dict]) -> float | None:
        """The median mount p95 of the nodes with enough samples; None with
        fewer than two (an outlier needs a herd)."""
        samples = []
        for entry in fresh.values():
            mount = entry.get("mount") or {}
            if (mount.get("count") or 0) < int(self.cfg.health_min_samples):
                continue
            p95 = mount.get("p95_ms")
            if p95 is not None:
                samples.append(float(p95))
        if len(samples) < 2:
            return None
        return float(statistics.median(samples))

    def _score(self, rec: _NodeRecord, entry: dict, median: float | None) -> list[str]:
        """The node's signals this pass, each naming its evidence (the
        flight record, and invariant 20, attribute a quarantine to them)."""
        signals: list[str] = []
        mount = entry.get("mount") or {}
        count = int(mount.get("count") or 0)
        p95 = mount.get("p95_ms")
        if median is not None and median > 0 and count >= int(self.cfg.health_min_samples) \
                and p95 is not None:
            bar = max(median * float(self.cfg.health_p95_multiplier),
                      median + float(self.cfg.health_p95_floor_ms))
            if float(p95) >= bar:
                signals.append(f"mount_p95_outlier(p95={float(p95):.0f}ms "
                               f"fleet_median={median:.0f}ms bar={bar:.0f}ms)")
        errors = int(mount.get("error") or 0)
        successes = int(mount.get("success") or 0)
        if errors + successes >= int(self.cfg.health_min_samples):
            if errors / float(errors + successes) >= float(self.cfg.health_error_ratio):
                signals.append(f"mount_error_ratio({errors}/{errors + successes})")
        if rec.canary_fails > 0:
            signals.append(f"canary_failures(x{rec.canary_fails}: "
                           f"{rec.canary_detail or 'probe failed'})")
        # the canary's own failed probes may be what opened the breaker: one
        # incident, one signal
        if entry.get("breaker") == "open" and rec.canary_fails == 0:
            signals.append("breaker_open")
        return signals

    def _step(self, node: str, rec: _NodeRecord, signals: list[str],
              budget_left: int) -> dict | None:
        """One pass of the node's state machine; the transition's event (for
        the records, outside the lock) or None."""
        bad = bool(signals)
        if bad:
            rec.signals = list(signals)
        if rec.state in ("healthy", "suspect"):
            if bad:
                rec.strikes += 1
                rec.clear = 0
                if rec.state == "healthy" and \
                        rec.strikes >= int(self.cfg.health_suspect_strikes):
                    return self._transition(node, rec, "suspect", signals)
                if rec.state == "suspect" and \
                        rec.strikes >= int(self.cfg.health_quarantine_strikes):
                    if budget_left <= 0:
                        BUDGET_DENIALS.inc()
                        logger.warning("quarantine of %s suppressed: fleet quarantine budget "
                                       "exhausted (signals: %s)", node, "; ".join(signals))
                        return None
                    return self._transition(node, rec, "quarantined", signals)
            else:
                rec.clear += 1
                rec.signals = []
                if rec.clear >= int(self.cfg.health_clear_passes):
                    rec.strikes = 0
                    if rec.state == "suspect":
                        return self._transition(node, rec, "healthy", ["cleared"])
        elif rec.state == "quarantined":
            # quarantined and still an outlier: it burns the tenants' SLOs,
            # and after health_drain_burn_passes the pane recommends moving
            # them off
            if any(s.startswith("mount_p95_outlier") for s in signals):
                rec.slo_burn += 1
                if rec.slo_burn >= int(self.cfg.health_drain_burn_passes) \
                        and not rec.drain_recommended:
                    rec.drain_recommended = True
                    return {"node": node, "from": "quarantined", "to": "quarantined",
                            "signals": list(signals),
                            "summary": f"{node}: drain recommended (SLO burn attributed for "
                                       f"{rec.slo_burn} passes while quarantined)"}
            else:
                rec.slo_burn = 0
            if rec.manual:
                return None  # an operator's quarantine leaves by an operator
            if not bad:
                rec.clear += 1
                ready = (rec.canary_ok >= int(self.cfg.health_rehab_canary_passes)
                         if self.canary_active else
                         rec.clear >= int(self.cfg.health_rehab_canary_passes))
                if ready:
                    rec.probation_clear = 0
                    return self._transition(node, rec, "rehabilitating",
                                            ["canary_passes" if self.canary_active
                                             else "clean_passes"])
            else:
                rec.clear = 0
                rec.canary_ok = 0
        elif rec.state == "rehabilitating":
            if bad:
                # a flap: straight back, past the budget (it held a slot
                # moments ago)
                rec.canary_ok = 0
                rec.clear = 0
                return self._transition(node, rec, "quarantined", signals)
            rec.probation_clear += 1
            if rec.probation_clear >= int(self.cfg.health_probation_passes):
                rec.strikes = rec.clear = 0
                rec.slo_burn = 0
                rec.drain_recommended = False
                return self._transition(node, rec, "healthy", ["probation_complete"])
        return None

    def _transition(self, node: str, rec: _NodeRecord, to: str, signals: list[str]) -> dict:
        src = rec.state
        rec.state = to
        rec.since = time.time()
        rec.reason = "; ".join(signals)
        if to == "healthy":
            rec.signals = []
        return {"node": node, "from": src, "to": to, "signals": list(signals),
                "summary": f"{node}: {src} -> {to} ({rec.reason})"}

    def _announce(self, ev: dict) -> None:
        """A transition's counter and its flight record, with its signals."""
        if ev["from"] != ev["to"]:
            QUARANTINE_TRANSITIONS.inc(from_state=ev["from"], to_state=ev["to"])
        try:
            FLIGHT.record("health", ev["summary"], node=ev["node"], from_state=ev["from"],
                          to_state=ev["to"], signals=list(ev["signals"]))
        except Exception:  # noqa: BLE001 — the observer's own observability
            logger.exception("health flight record failed")
        logger.warning("health: %s", ev["summary"])

    def _export_gauge_locked(self) -> None:
        counts = {s: 0 for s in STATES}
        for rec in self._nodes.values():
            if not rec.evacuated:
                counts[rec.state] += 1
        for state, n in counts.items():
            NODE_HEALTH_STATE.set(float(n), state=state)

    # --- the canary's outcomes ---

    def record_canary(self, node: str, ok: bool, detail: str = "") -> None:
        """One canary probe's outcome, as streaks: the next scoring pass
        turns them into transitions (canary and collection cadences stay
        apart)."""
        with self._lock:
            rec = self._nodes.setdefault(node, _NodeRecord())
            if ok:
                rec.canary_ok += 1
                rec.canary_fails = 0
                rec.canary_detail = ""
            else:
                rec.canary_fails += 1
                rec.canary_ok = 0
                rec.canary_detail = detail

    # --- the consumers' reads (never raise; open on failure) ---

    def excluded_hosts(self) -> frozenset[str]:
        """The quarantined nodes: no new work goes there. Never raises: a
        broken plane fails open, it does not fence the fleet."""
        try:
            with self._lock:
                return frozenset(n for n, r in self._nodes.items()
                                 if r.state == "quarantined" and not r.evacuated)
        except Exception:  # noqa: BLE001 — a consumer's read
            return frozenset()

    def probation_hosts(self) -> frozenset[str]:
        """The rehabilitating nodes: placeable, when nowhere better is."""
        try:
            with self._lock:
                return frozenset(n for n, r in self._nodes.items()
                                 if r.state == "rehabilitating" and not r.evacuated)
        except Exception:  # noqa: BLE001 — a consumer's read
            return frozenset()

    def is_quarantined(self, node: str) -> bool:
        return node in self.excluded_hosts()

    # --- the operator's verbs (POST /health/quarantine/<node>) ---

    def quarantine(self, node: str, reason: str = "", actor: str = "operator") -> dict:
        """An operator's quarantine: past the budget, and released only by
        an operator."""
        with self._lock:
            rec = self._nodes.setdefault(node, _NodeRecord())
            if rec.evacuated:
                raise ValueError(f"{node} was evacuated by the recovery plane; quarantine "
                                 f"would be meaningless")
            if rec.state == "quarantined":
                return rec.pane()
            rec.manual = True
            ev = self._transition(node, rec, "quarantined",
                                  [f"manual({actor}: {reason or 'no reason given'})"])
            self._export_gauge_locked()
            pane = rec.pane()
        self._announce(ev)
        self._persist()
        return pane

    def release(self, node: str, actor: str = "operator") -> dict:
        """An operator's release, straight to healthy. Refuses a node the
        recovery plane evacuated: a release does not raise the dead."""
        # the recovery plane's lock never nests under health.state
        recovery_says_dead = self._recovery_evacuated(node)
        with self._lock:
            rec = self._nodes.get(node)
            if rec is None or rec.state == "healthy":
                raise ValueError(f"{node} is not quarantined")
            if rec.evacuated or recovery_says_dead:
                raise ValueError(f"{node} was evacuated by the recovery plane; it cannot be "
                                 f"released back — it must re-register as a fresh worker")
            ev = self._transition(node, rec, "healthy", [f"manual_release({actor})"])
            rec.manual = False
            rec.strikes = rec.clear = rec.canary_ok = rec.canary_fails = 0
            rec.slo_burn = 0
            rec.drain_recommended = False
            self._export_gauge_locked()
            pane = rec.pane()
        self._announce(ev)
        self._persist()
        return pane

    def _recovery_evacuated(self, node: str) -> bool:
        if self.recovery is None:
            return False
        try:
            return self.recovery.is_evacuated(node)
        except Exception:  # noqa: BLE001 — advisory, across planes
            return False

    def note_evacuated(self, node: str) -> None:
        """The recovery plane evacuated `node`: its record retires, and the
        scorer stops reasoning about it."""
        with self._lock:
            rec = self._nodes.get(node)
            if rec is None or rec.evacuated:
                return
            was = rec.state
            rec.evacuated = True
            self._export_gauge_locked()
        if was in ("quarantined", "rehabilitating"):
            try:
                FLIGHT.record("health", f"{node}: {was} superseded by evacuation", node=node,
                              from_state=was, to_state="evacuated",
                              signals=["recovery.evacuate"])
            except Exception:  # noqa: BLE001
                logger.exception("health flight record failed")
            self._persist()

    # --- persistence (a takeover keeps the set) ---

    def _persist(self) -> None:
        if self.store is None:
            return
        with self._lock:
            state = {"version": 1,
                     "nodes": {n: {"state": r.state, "since": r.since, "reason": r.reason,
                                   "manual": r.manual}
                               for n, r in self._nodes.items()
                               if r.state in ("quarantined", "rehabilitating")
                               and not r.evacuated}}
        try:
            self.store.save_health_state(state)
        except Exception as exc:  # noqa: BLE001 — best effort: memory is this
            # master's truth
            logger.warning("health state persist failed: %s", exc)

    def load(self) -> int:
        """Restore the quarantined and rehabilitating nodes a previous
        master persisted; the others rebuild from telemetry. Returns how
        many were restored."""
        if self.store is None:
            return 0
        try:
            state = self.store.load_health_state()
        except Exception as exc:  # noqa: BLE001 — fail open
            logger.warning("health state load failed: %s", exc)
            return 0
        if not state or not isinstance(state.get("nodes"), dict):
            return 0
        restored = 0
        with self._lock:
            for node, saved in state["nodes"].items():
                if saved.get("state") not in ("quarantined", "rehabilitating"):
                    continue
                rec = self._nodes.setdefault(node, _NodeRecord())
                rec.state = saved["state"]
                rec.since = float(saved.get("since") or time.time())
                rec.reason = str(saved.get("reason") or "restored")
                rec.manual = bool(saved.get("manual"))
                restored += 1
            self._export_gauge_locked()
        if restored:
            logger.warning("health: restored %d quarantined/rehabilitating node(s) from the "
                           "store (takeover continuity)", restored)
        return restored

    # --- the pane ---

    def payload(self) -> dict:
        with self._lock:
            nodes = {n: r.pane() for n, r in self._nodes.items()}
            counts = {s: 0 for s in STATES}
            for r in self._nodes.values():
                if not r.evacuated:
                    counts[r.state] += 1
            total = self._last_pass.get("total") or len(nodes)
            budget = float(self.cfg.health_quarantine_budget)
            return {
                "enabled": self.enabled,
                "nodes": nodes,
                "states": counts,
                "quarantine_budget": {"fraction": budget,
                                      "max_nodes": max(1, int(total * budget)),
                                      "used": counts["quarantined"]},
                "canary_active": self.canary_active,
                "last_pass": dict(self._last_pass),
            }


class CanaryProber:
    """The active probe: a real mount -> ProbeGPU -> unmount through the
    whole worker path (grant, mknod, ledger), into the node's reserved
    canary pod, each HEALTH_CANARY_INTERVAL_S, for every suspect,
    quarantined and rehabilitating node. It rides the mount path's client
    (the plane dedupes the breaker's echo); a node whose canary pod is not
    scheduled answers PodNotFound, a skip."""

    def __init__(self, plane: HealthPlane, registry, client_factory, cfg=None, probe=None):
        self.cfg = cfg or Config()
        self.plane = plane
        self.registry = registry
        self.client_factory = client_factory
        #: probe(node, address) -> (ok: bool | None, detail); None: skip
        self.probe = probe or self._default_probe
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "CanaryProber":
        if not self.plane.enabled or float(self.cfg.health_canary_interval_s) <= 0:
            return self
        self.plane.canary_active = True
        self._thread = threading.Thread(target=self._loop, name="canary-prober", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.plane.canary_active = False

    def _loop(self) -> None:
        while not self._stop.wait(float(self.cfg.health_canary_interval_s)):
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — the loop must survive a pass
                logger.exception("canary probe pass failed")

    def targets(self) -> list[str]:
        pane = self.plane.payload()["nodes"]
        return sorted(n for n, rec in pane.items()
                      if rec["state"] in ("suspect", "quarantined", "rehabilitating")
                      and not rec["evacuated"])

    def probe_once(self) -> int:
        """One pass over the targets, on the shared fan-out core (they are the
        nodes most likely to take the whole deadline); returns the probes
        driven, skips left out."""
        snapshot = dict(self.registry.registry_snapshot())
        work = [(node, f"{snapshot[node]}:{self.cfg.worker_port}")
                for node in self.targets() if node in snapshot]
        if not work:
            return 0

        def _probe_one(item: tuple[str, str]):
            node, address = item
            try:
                ok, detail = self.probe(node, address)
            except Exception as exc:  # noqa: BLE001 — a probe that cannot even
                # dial is the evidence
                ok, detail = False, f"{type(exc).__name__}: {exc}"
            return node, ok, detail

        driven = 0
        for node, ok, detail in get_core(self.cfg).run(work, _probe_one, kind="canary-probe"):
            if ok is None:
                continue  # no canary pod on the node: a skip
            driven += 1
            CANARY_PROBES.inc()
            if not ok:
                CANARY_FAILURES.inc()
            self.plane.record_canary(node, ok, detail)
        return driven

    def _default_probe(self, node: str, address: str) -> tuple[bool | None, str]:
        pod = f"{self.cfg.health_canary_pod_prefix}{node}"
        ns = self.cfg.health_canary_namespace
        timeout = float(self.cfg.health_canary_timeout_s)
        failpoints.fire("health.canary", node=node)
        t0 = time.monotonic()
        with self.client_factory(address) as client:
            result = api.AddGPUResult(client.add_gpu(pod, ns, 1, timeout_s=timeout)
                                      .add_gpu_result)
            if result == api.AddGPUResult.PodNotFound:
                return None, "canary pod not scheduled"
            if result != api.AddGPUResult.Success:
                return False, f"canary mount refused: {result.name}"
            try:
                probe, chips = client.probe_gpu(pod, ns, timeout_s=timeout)
                if probe != api.ProbeGPUResult.Success or not chips:
                    return False, "canary chip probe failed"
                if any(not c.healthy for c in chips):
                    return False, "canary chip unhealthy"
            finally:
                client.remove_gpu(pod, ns, [], force=True, remove_all=True, timeout_s=timeout)
        ms = (time.monotonic() - t0) * 1000.0
        if ms > timeout * 1000.0:
            return False, f"canary path took {ms:.0f}ms (> deadline)"
        return True, f"ok ({ms:.0f}ms)"
