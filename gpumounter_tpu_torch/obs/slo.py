"""Declarative SLOs with a two-window burn rate.

The counterpart of ``gpumounter_tpu/obs/slo.py``. An ``Objective`` declares
a good-events target over the fleet rollup (``obs/fleet.py``): a latency
objective ("this share of mounts within threshold_s", from the merged mount
histogram), a ratio objective (good against bad counter keys, as heal
success), or a tenant-downtime objective (the tenants' disruption windows
of one cause within threshold_s). The engine keeps cumulative (good, total)
samples an objective and evaluates the burn rate, the share of the error
budget being spent, over two windows:

    burn = (bad / total within the window) / (1 - target)

A breach needs the burn over the threshold in BOTH the fast window (react
in minutes) and the slow one (ignore blips), with traffic in the fast one.
A breach's transition posts a Kubernetes Event, reason ``GPUSLOBurnRate``
(the reference's ``TPUSLOBurnRate``, under the GPU name the port's other
Events take), writes an audit record inside an ``slo.breach`` span and
puts the Event on the flight recorder's timeline; a latency breach names
the fleet's dominant phase (``obs/assembly.py``).

A counter reset (a worker's restart) only shrinks cumulative values, so a
window's deltas are clamped at zero: a restart reads as no traffic, never
as a negative burn. The heal and migration objectives read the master's
counters by name (``obs/fleet.py``), which read 0 until the packages that
count them are ported, as on a reference master that never healed.
Standard library only.
"""

from __future__ import annotations

import json
import secrets
import time
from collections import deque
from dataclasses import asdict, dataclass, field

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.obs import assembly, trace
from gpumounter_tpu_torch.obs.audit import AUDIT
from gpumounter_tpu_torch.obs.flight import FLIGHT
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("obs.slo")

#: the breach Event's reason
BREACH_REASON = "GPUSLOBurnRate"

SLO_BURN_RATE = REGISTRY.gauge(
    "tpumounter_slo_burn_rate",
    "Error-budget burn rate by objective and window (1.0 = consuming "
    "budget exactly at the sustainable rate)")
SLO_BREACHES = REGISTRY.counter(
    "tpumounter_slo_breaches_total",
    "Multi-window burn-rate breach transitions by objective")
SLO_BREACHED = REGISTRY.gauge(
    "tpumounter_slo_breached",
    "1 while the objective is in breach (both windows over threshold)")


class ObjectiveError(ValueError):
    """An SLO objective declaration is invalid."""


@dataclass(frozen=True)
class Objective:
    name: str
    kind: str                 # "latency" | "ratio" | "tenant-downtime"
    target: float             # the good share, in (0, 1)
    threshold_s: float = 0.0  # latency kinds: the bound that is good
    good: str = ""            # ratio: the rollup's counter of good events
    bad: str = ""             # ratio: the rollup's counter of bad events
    #: tenant-downtime: the disruption cause whose merged downtime
    #: histogram is judged
    cause: str = "migration"
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("latency", "ratio", "tenant-downtime"):
            raise ObjectiveError(f"{self.name}: unknown kind {self.kind!r}")
        if not 0.0 < self.target < 1.0:
            raise ObjectiveError(f"{self.name}: target must be in (0, 1), got {self.target}")
        if self.kind in ("latency", "tenant-downtime") and self.threshold_s <= 0:
            raise ObjectiveError(f"{self.name}: {self.kind} needs threshold_s")
        if self.kind == "ratio" and not (self.good and self.bad):
            raise ObjectiveError(f"{self.name}: ratio needs good and bad keys")


#: the built-in objectives, the reference's (TPUMOUNTER_SLO_OBJECTIVES
#: replaces them)
DEFAULT_OBJECTIVES: tuple[Objective, ...] = (
    Objective(name="mount-latency-50ms", kind="latency", threshold_s=0.05, target=0.95,
              description="95% of hot-mounts complete within 50 ms "
                          "(warm-path latency promise)"),
    Objective(name="mount-success", kind="ratio", target=0.999,
              good="mount_success", bad="mount_error",
              description="99.9% of mount operations succeed"),
    Objective(name="heal-success", kind="ratio", target=0.99,
              good="heals", bad="heal_failures",
              description="99% of chip heals succeed"),
    # the tenants' objectives: no tenant traffic, no burn
    Objective(name="tenant-migration-downtime", kind="tenant-downtime",
              cause="migration", threshold_s=2.5, target=0.95,
              description="95% of tenant-visible migration disruption "
                          "windows close within 2.5 s (p95 "
                          "tenant-visible migration downtime)"),
    Objective(name="tenant-disruption-free-minutes", kind="ratio",
              target=0.999, good="tenant_clean_minutes",
              bad="tenant_disrupted_minutes",
              description="99.9% of tenant wall-clock minutes are "
                          "disruption-free"),
    # the capacity plane's per-pass evaluations (obs/capacity.py): bad events
    # are denials a defragmentation would lift, never a full fleet; a master
    # without the plane sees no traffic
    Objective(name="slice-feasibility", kind="ratio", target=0.9,
              good="slice_feasible", bad="slice_infeasible",
              description="90% of per-pass accelerator-size "
                          "feasibility evaluations are not denied by "
                          "fragmentation alone (large-block "
                          "admissibility: burn means defrag would "
                          "unlock blocked slice shapes)"),
)


def objectives_from_config(cfg) -> tuple[Objective, ...]:
    """TPUMOUNTER_SLO_OBJECTIVES (a JSON list of Objective fields), or the
    defaults. A malformed declaration raises at start: alerting on nothing
    would be worse than not starting."""
    raw = cfg.slo_objectives or ""
    if not raw.strip():
        return DEFAULT_OBJECTIVES
    try:
        docs = json.loads(raw)
    except ValueError as exc:
        raise ObjectiveError(f"TPUMOUNTER_SLO_OBJECTIVES is not JSON: {exc}")
    if not isinstance(docs, list):
        raise ObjectiveError("TPUMOUNTER_SLO_OBJECTIVES must be a JSON list")
    return tuple(Objective(**doc) for doc in docs)


def _good_within(buckets, threshold_s: float) -> float:
    """The cumulative count at the largest bucket bound <= threshold: a
    cumulative histogram's fast-enough events."""
    good = 0.0
    best_bound = None
    for bound, cum in buckets or []:
        if float(bound) <= threshold_s + 1e-12 and (best_bound is None
                                                   or float(bound) > best_bound):
            best_bound = float(bound)
            good = float(cum)
    return good


def _good_total(objective: Objective, rollup: dict) -> tuple[float, float]:
    """An objective's cumulative (good, total) from a fleet rollup."""
    fleet = rollup.get("fleet") or {}
    if objective.kind == "latency":
        return (_good_within(fleet.get("mount_buckets"), objective.threshold_s),
                float(fleet.get("mount_count", 0)))
    if objective.kind == "tenant-downtime":
        downtime = ((rollup.get("tenants_fleet") or {}).get("downtime") or {}).get(
            objective.cause) or {}
        return (_good_within(downtime.get("buckets"), objective.threshold_s),
                float(downtime.get("count", 0)))
    counters = {**(rollup.get("master") or {}),
                "mount_success": fleet.get("mount_success", 0.0),
                "mount_error": fleet.get("mount_error", 0.0)}
    for key in ("tenant_clean_minutes", "tenant_disrupted_minutes"):
        counters[key] = float((rollup.get("tenants_fleet") or {}).get(key, 0.0))
    good = float(counters.get(objective.good, 0.0))
    bad = float(counters.get(objective.bad, 0.0))
    return good, good + bad


@dataclass
class _ObjectiveState:
    objective: Objective
    #: cumulative (monotonic time, good, total) samples, newest last
    samples: deque = field(default_factory=lambda: deque(maxlen=4096))
    breached: bool = False


class SloEngine:
    """Takes fleet rollups, evaluates burn rates, emits breaches."""

    def __init__(self, cfg=None, kube=None, objectives: tuple[Objective, ...] | None = None,
                 clock=time.monotonic):
        self.cfg = cfg or Config()
        self.kube = kube
        self.clock = clock
        self.fast_window_s = self.cfg.slo_fast_window_s
        self.slow_window_s = self.cfg.slo_slow_window_s
        self.burn_threshold = self.cfg.slo_burn_threshold
        self._states = {o.name: _ObjectiveState(o) for o in
                        (objectives if objectives is not None
                         else objectives_from_config(self.cfg))}
        self._evaluated_at = 0.0
        # the collector's thread ingests while /slo's evaluate: the samples
        # and the breach transitions share one lock; the emission (the
        # Event's POST, the record) runs outside it
        self._lock = OrderedLock("slo.states")

    # --- sampling ---

    def ingest(self, rollup: dict) -> None:
        """One rollup's cumulative counts, a sample an objective (the
        collector calls it after each pass). The same rollup again adds a
        sample of equal counts, never events."""
        now = self.clock()
        with self._lock:
            for state in self._states.values():
                good, total = _good_total(state.objective, rollup)
                state.samples.append((now, good, total))

    def _window_burn(self, state: _ObjectiveState, now: float,
                     window_s: float) -> tuple[float, float]:
        """(burn rate, events) over the trailing window, from the newest
        sample at or before the window's start, or from zero when the
        history is shorter (an engine that just started alerts on all it
        has seen: a breach must not hide behind a restart)."""
        samples = list(state.samples)
        if not samples:
            return 0.0, 0.0
        _, latest_good, latest_total = samples[-1]
        base_good = base_total = 0.0
        for t, good, total in reversed(samples):
            if now - t >= window_s:
                base_good, base_total = good, total
                break
        # a counter reset shrinks cumulative values: no traffic, not a
        # negative burn
        d_total = max(0.0, latest_total - base_total)
        d_good = min(max(0.0, latest_good - base_good), d_total)
        if d_total <= 0:
            return 0.0, 0.0
        budget = 1.0 - state.objective.target
        return ((d_total - d_good) / d_total) / budget if budget > 0 else 0.0, d_total

    # --- evaluation ---

    def evaluate(self) -> dict:
        """Every objective over both windows, the breaches' transitions
        emitted; the /slo payload."""
        now = self.clock()
        out = []
        breaches: list[tuple[Objective, float, float]] = []
        with self._lock:
            for state in self._states.values():
                name = state.objective.name
                burn_fast, events_fast = self._window_burn(state, now, self.fast_window_s)
                burn_slow, _ = self._window_burn(state, now, self.slow_window_s)
                SLO_BURN_RATE.set(round(burn_fast, 4), objective=name, window="fast")
                SLO_BURN_RATE.set(round(burn_slow, 4), objective=name, window="slow")
                breached = (events_fast > 0 and burn_fast >= self.burn_threshold
                            and burn_slow >= self.burn_threshold)
                if breached and not state.breached:
                    # one concurrent evaluator wins the transition; the
                    # emission comes after the lock
                    breaches.append((state.objective, burn_fast, burn_slow))
                elif state.breached and not breached:
                    logger.info("SLO %s recovered (burn fast=%.2f slow=%.2f)", name,
                                burn_fast, burn_slow)
                state.breached = breached
                SLO_BREACHED.set(1.0 if breached else 0.0, objective=name)
                _, good, total = state.samples[-1] if state.samples else (now, 0.0, 0.0)
                out.append({**asdict(state.objective),
                            "sli": round(good / total, 6) if total else None,
                            "good_events": good, "total_events": total,
                            "burn_fast": round(burn_fast, 4),
                            "burn_slow": round(burn_slow, 4),
                            "breached": breached})
        for objective, burn_fast, burn_slow in breaches:
            self._emit_breach(objective, burn_fast, burn_slow)
        self._evaluated_at = time.time()
        return {"evaluated_at": round(self._evaluated_at, 3),
                "burn_threshold": self.burn_threshold,
                "windows_s": {"fast": self.fast_window_s, "slow": self.slow_window_s},
                "objectives": out}

    def payload(self) -> dict:
        return self.evaluate()

    # --- a breach ---

    def _emit_breach(self, objective: Objective, burn_fast: float, burn_slow: float) -> None:
        """One breach's transition: the counter, an audit record inside an
        ``slo.breach`` span (so it carries a trace id), and the Event; a
        latency breach names the fleet's dominant phase."""
        SLO_BREACHES.inc(objective=objective.name)
        message = (f"SLO {objective.name} burning error budget at {burn_fast:.1f}x (fast "
                   f"window) / {burn_slow:.1f}x (slow window), threshold "
                   f"{self.burn_threshold:.1f}x: {objective.description or objective.kind}")
        dominant = None
        if objective.kind == "latency":
            try:
                dominant = assembly.fleet_dominant_phase()
            except Exception:  # noqa: BLE001 — the attribution is advisory
                logger.exception("dominant-phase attribution failed")
        if dominant:
            message += (f"; fleet-dominant phase: {dominant['phase']} "
                        f"({dominant['share']:.0%} of recent mount wall time across "
                        f"{dominant['traces']} trace(s))")
        logger.warning("%s", message)
        with trace.span("slo.breach", objective=objective.name):
            AUDIT.record("slo.breach", actor="slo-engine",
                         outcome=f"breach: {objective.name}",
                         burn_fast=round(burn_fast, 4), burn_slow=round(burn_slow, 4),
                         target=objective.target,
                         **({"dominant_phase": dominant["phase"],
                             "dominant_share": dominant["share"]} if dominant else {}))
            self._post_event(objective, message)

    def _post_event(self, objective: Objective, message: str) -> None:
        summary = f"{BREACH_REASON}: {message}"[:240]
        if self.kube is None:
            FLIGHT.record("event", summary, reason=BREACH_REASON,
                          objective=objective.name, posted=False)
            return
        ts = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        namespace = self.cfg.worker_namespace
        manifest = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": f"tpumounter-slo-{objective.name[:100]}"
                                 f".{secrets.token_hex(4)}",
                         "namespace": namespace},
            # a fleet's condition, not a pod's: the master's Service
            "involvedObject": {"kind": "Service", "name": "tpumounter-master",
                               "namespace": namespace},
            "reason": BREACH_REASON,
            "message": message[:1024],
            "type": "Warning",
            "source": {"component": "tpumounter-master"},
            "firstTimestamp": ts,
            "lastTimestamp": ts,
            "count": 1,
        }
        posted = True
        try:
            self.kube.create_event(namespace, manifest)
        except Exception as exc:  # noqa: BLE001 — events are advisory
            posted = False
            logger.warning("SLO breach event post failed: %s", exc)
        FLIGHT.record("event", summary, reason=BREACH_REASON, objective=objective.name,
                      posted=posted)
