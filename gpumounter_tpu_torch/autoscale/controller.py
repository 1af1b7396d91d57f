"""The autoscale controller: tenant telemetry in, elastic intents out, gated.

The counterpart of ``gpumounter_tpu/autoscale/controller.py``. One a master,
built by ``MasterApp`` after the defragmenter. A pass reads:

  * the throughput model (``autoscale/model.py``): whether the tenant's
    slice is saturated (``utilization`` against its fitted plateau), and
    whether its telemetry may be trusted at all (``stale`` and ``sparse``
    refuse);
  * the queue depth of the same /tenants snapshots, the demand;
  * the capacity plane's view of each host (``obs/capacity.host_capacity``):
    a grow is admissible where one host's free GPUs hold it, and
    admissible-after-defrag where its free and warm GPUs do but the free
    ones alone do not. On NVSwitch every free GPU of a host is one block,
    so only warm holders make the second verdict; the reference's ICI
    singletons do not exist here. A grow that waits for a defrag asks the
    defragmenter for a plan and its run. The health plane's quarantined
    hosts (``excluded_hosts()``, fail-open) are never capacity;
  * the gates: while a tenant objective burns (``GATING_OBJECTIVES``) or
    the SLO engine fails, every decision is refused; a degraded Kubernetes
    API or a pause parks the pass at the next tenant boundary, and the
    decisions already written stand;
  * hysteresis (a signal held for ``autoscale_hysteresis`` passes in a
    row) and a cooldown a tenant; a shrink never goes below the tenant's
    ``min_chips`` nor a grow above ``max_gpu_per_request``.

A decision writes the tenant's intent (``IntentStore.put``) and enqueues it
on the reconciler, which owns the convergence. Each is audited
(``autoscale.decision``), stamped with the pass's trace id and marked on the
flight recorder; the series carry the outcome and cause vocabularies only
(tenant names ride the /autoscale pane). The JSON keys (``from_chips``,
``to_chips``, ``chips``, ...), audit operations, series names and the skip
and refusal vocabularies are the reference's.

``enforce_gates`` is the chaos harness's negative control only: with it off
each decision still records the true gate state, so that invariant 21 can
show a decision fired through a closed gate.
"""

from __future__ import annotations

import copy
import threading
import time
from collections import deque

from gpumounter_tpu_torch.autoscale.model import ThroughputModel
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.elastic.intents import Intent
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.k8s.errors import is_outage
from gpumounter_tpu_torch.obs import trace
from gpumounter_tpu_torch.obs.audit import AUDIT
from gpumounter_tpu_torch.obs.capacity import host_capacity
from gpumounter_tpu_torch.obs.flight import FLIGHT
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("autoscale")

#: the objectives whose burn refuses every decision; slice-feasibility is not
#: one, since a fragmented fleet is when a grow may ask for a defrag
GATING_OBJECTIVES = ("tenant-migration-downtime", "tenant-disruption-free-minutes")

AUTOSCALE_DECISIONS = REGISTRY.counter(
    "tpumounter_autoscale_decisions_total",
    "Scale decisions fired, by outcome (grow|shrink)")
AUTOSCALE_SKIPS = REGISTRY.counter(
    "tpumounter_autoscale_skips_total",
    "Per-tenant evaluations that held, by bounded reason vocabulary")
AUTOSCALE_REFUSALS = REGISTRY.counter(
    "tpumounter_autoscale_refusals_total",
    "Whole passes refused/parked, by bounded cause vocabulary")
AUTOSCALE_PASSES = REGISTRY.counter(
    "tpumounter_autoscale_passes_total",
    "Evaluate passes completed (including no-decision passes)")
AUTOSCALE_PAUSED = REGISTRY.gauge(
    "tpumounter_autoscale_paused",
    "1 while the autoscaler is operator-paused")


class AutoscaleRefused(Exception):
    """A gate's or the pause's refusal, with its HTTP status. The causes:
    slo-burn | api-degraded | paused | busy | stale-telemetry."""

    def __init__(self, message: str, cause: str, status: int = 409):
        super().__init__(message)
        self.cause = cause
        self.status = status


#: a tenant's hold reasons (the skips counter's label values)
SKIP_REASONS = ("stale-telemetry", "sparse-telemetry", "untracked", "cooldown", "hysteresis",
                "at-floor", "at-ceiling", "infeasible", "steady", "error")


class AutoscaleController:
    """The decision state is in memory: a restarted master learns its streaks
    and cooldowns again within a few passes; the intents it wrote are the
    durable output, journaled as every intent is."""

    def __init__(self, elastic, capacity, fleet, slo=None, apihealth=None, health=None,
                 defrag=None, cfg=None, model=None, clock=None):
        self.cfg = cfg or Config()
        self.elastic = elastic
        self.capacity = capacity
        self.fleet = fleet
        self.slo = slo
        self.apihealth = apihealth
        self.health = health
        #: a DefragController: an admissible-after-defrag grow asks it for a
        #: plan and runs it
        self.defrag = defrag
        self.clock = clock or time.time
        self.model = model or ThroughputModel(cfg=self.cfg, clock=self.clock)
        #: the harness's negative control; see the module's docstring
        self.enforce_gates = True
        self._lock = OrderedLock("autoscale.state")
        self._paused = threading.Event()
        #: tenant -> {"grow": streak, "shrink": streak}
        self._streaks: dict[str, dict] = {}
        #: tenant -> its last decision's time
        self._cooldowns: dict[str, float] = {}
        self._history: deque[dict] = deque(maxlen=32)
        self._last_pass: dict | None = None
        self._pass_mu = OrderedLock("autoscale.pass")
        self._stop = threading.Event()
        self._loop_thread: threading.Thread | None = None

    # --- gates ---

    def _gate_state(self) -> dict:
        burning = []
        if self.slo is not None:
            try:
                evaluation = self.slo.evaluate()
            except Exception as exc:  # noqa: BLE001 — a broken engine reads as burning
                logger.warning("slo evaluation for autoscale gate failed: %s", exc)
                burning = ["slo-engine-error"]
            else:
                threshold = float(evaluation.get("burn_threshold", 2.0))
                for objective in evaluation.get("objectives", []):
                    if objective.get("name") not in GATING_OBJECTIVES:
                        continue
                    if objective.get("breached") or \
                            float(objective.get("burn_fast", 0.0)) >= threshold:
                        burning.append(objective["name"])
        api_ok = self.apihealth is None or self.apihealth.ok()
        return {"api_ok": api_ok,
                "api_state": self.apihealth.state() if self.apihealth is not None else "ok",
                "slo_burning": burning,
                "paused": self._paused.is_set()}

    def _check_gates(self, action: str) -> dict:
        gates = self._gate_state()
        if not self.enforce_gates:
            return gates
        if gates["paused"]:
            self._refuse(action, "paused", "autoscaler is operator-paused; POST "
                         "/autoscale/resume to re-enable", 409)
        if not gates["api_ok"]:
            self._refuse(action, "api-degraded", f"k8s api is {gates['api_state']}; the "
                         f"autoscaler parks until it heals", 503)
        if gates["slo_burning"]:
            self._refuse(action, "slo-burn", f"SLO burning: {', '.join(gates['slo_burning'])}"
                         f"; refusing to scale into a breach", 503)
        return gates

    def _refuse(self, action: str, cause: str, message: str, status: int = 409) -> None:
        AUTOSCALE_REFUSALS.inc(outcome=cause)
        AUDIT.record(f"autoscale.{action}", actor="autoscale-controller",
                     outcome=f"refused: {cause}", cause=cause, detail=message)
        raise AutoscaleRefused(message, cause, status)

    # --- where a grow would land ---

    def _grow_feasibility(self, need: int, nodes: dict,
                          claims: list[int] | None = None) -> dict:
        """Can the fleet place `need` more GPUs on one host that is not
        quarantined? The capacity plane's verdicts. A host's block is its
        free GPUs (NVSwitch); warm GPUs count toward after-defrag only, as
        reclaimable bookings.

        claims: the GPUs granted to earlier tenants in this pass, which the
        snapshot cannot see yet (a decision is an intent, not a mount), laid
        best-fit over the hosts first, so that the order of evaluation is the
        order of allocation under contention."""
        excluded = frozenset()
        if self.health is not None:
            try:
                excluded = self.health.excluded_hosts()
            except Exception:  # noqa: BLE001 — fail-open, as every consumer
                excluded = frozenset()
        hosts = []
        warm_ready = 0
        for node, entry in nodes.items():
            if node in excluded:
                continue
            cap = host_capacity((entry or {}).get("capacity"))
            if cap.get("capacity_unknown"):
                continue
            warm_ready += int(cap.get("warm_ready", 0))
            hosts.append({"largest_block": int(cap["largest_block"]),
                          "loose": int(cap["free"]) + int(cap["warm"])})
        for claim in claims or ():
            # the smallest block that holds it, so that big blocks survive
            fit = min((h for h in hosts if h["largest_block"] >= claim),
                      key=lambda h: h["largest_block"], default=None)
            if fit is None:
                fit = min((h for h in hosts if h["loose"] >= claim),
                          key=lambda h: h["loose"], default=None)
            if fit is not None:
                fit["largest_block"] = max(0, fit["largest_block"] - claim)
                fit["loose"] -= claim
        admissible_now = 0
        after_defrag = 0
        for h in hosts:
            if h["largest_block"] >= need:
                admissible_now += 1
            elif h["loose"] >= need:
                after_defrag += 1
        if admissible_now:
            verdict = "admissible"
        elif after_defrag:
            verdict = "admissible-after-defrag"
        else:
            verdict = "infeasible"
        return {"verdict": verdict, "chips": need, "hosts_admissible_now": admissible_now,
                "hosts_after_defrag": after_defrag, "warm_ready": warm_ready,
                "excluded_hosts": len(excluded)}

    def _request_defrag(self, tenant: str, need: int) -> None:
        """Hand a grow that waits for a defrag to the defragmenter (its own
        gates and budgets apply). Best effort: a refusal or a failure leaves
        the grow deferred, and the next pass evaluates it again."""
        FLIGHT.record("marker", f"autoscale: grow of {need} chip(s) for {tenant} needs "
                                f"defrag; requesting a plan")
        if self.defrag is None:
            return
        try:
            plan = self.defrag.plan()
            if plan.get("moves"):
                self.defrag.run(plan["id"])
        except Exception as exc:  # noqa: BLE001 — the deferral is recorded already
            logger.info("defrag request for %s deferred: %s", tenant, exc)

    # --- the pass ---

    def evaluate_once(self) -> dict:
        """One pass: fold fresh telemetry into the model, then evaluate every
        tenant with an intent, the higher ``priority`` first, then by name.
        Raises AutoscaleRefused when a gate is closed at the top; a gate that
        closes between tenants parks the rest of the pass (status
        parked-api, parked-slo or paused)."""
        with self._pass_mu:
            with trace.span("autoscale.pass"):
                return self._evaluate_traced()

    def _evaluate_traced(self) -> dict:
        now = self.clock()
        record = {"at": now, "status": "running", "decisions": [], "considered": 0,
                  "trace_id": trace.current_trace_id()}
        gates = self._check_gates("pass")
        failpoints.fire("autoscale.pass")
        try:
            rollup = self.fleet.payload(max_age_s=float(self.cfg.autoscale_stale_s))
        except Exception as exc:  # noqa: BLE001 — no fleet view: refused as stale
            self._refuse("pass", "stale-telemetry",
                         f"fleet collection failed "
                         f"({'api outage' if is_outage(exc) else exc}); refusing to scale "
                         f"blind", 503)
        nodes = rollup.get("nodes") or {}
        self.model.observe_nodes(nodes)
        try:
            intents = list(self.elastic.store.list())
        except Exception as exc:  # noqa: BLE001 — the listing rides the API
            self._refuse("pass", "api-degraded",
                         f"intent listing failed "
                         f"({'api outage' if is_outage(exc) else exc})", 503)
        from gpumounter_tpu_torch.obs.fleet import merge_tenants
        snapshots = merge_tenants(nodes)
        pass_claims: list[int] = []
        for namespace, pod_name, intent in sorted(intents,
                                                  key=lambda t: (-t[2].priority, t[0], t[1])):
            # the tenant boundary: the decisions already written stand
            gates = self._gate_state()
            if self.enforce_gates and not gates["api_ok"]:
                record["status"] = "parked-api"
                record["parked"] = gates["api_state"]
                AUTOSCALE_REFUSALS.inc(outcome="api-degraded")
                break
            if self.enforce_gates and gates["slo_burning"]:
                record["status"] = "parked-slo"
                record["parked"] = gates["slo_burning"]
                AUTOSCALE_REFUSALS.inc(outcome="slo-burn")
                break
            if self.enforce_gates and gates["paused"]:
                record["status"] = "paused"
                AUTOSCALE_REFUSALS.inc(outcome="paused")
                break
            record["considered"] += 1
            decision = self._decide(namespace, pod_name, intent, snapshots, nodes, gates, now,
                                    pass_claims)
            record["decisions"].append(decision)
            if decision["action"] == "grow":
                pass_claims.append(decision["to_chips"] - decision["from_chips"])
        if record["status"] == "running":
            record["status"] = "completed"
        AUTOSCALE_PASSES.inc()
        fired = [d for d in record["decisions"] if d["action"] in ("grow", "shrink")]
        if fired:
            AUDIT.record("autoscale.pass", actor="autoscale-controller",
                         outcome=f"{record['status']}: {len(fired)} decision(s) over "
                                 f"{record['considered']} tenant(s)",
                         decisions=len(fired), considered=record["considered"])
        with self._lock:
            self._last_pass = record
            self._history.append(copy.deepcopy(record))
        return copy.deepcopy(record)

    def _decide(self, namespace: str, pod_name: str, intent: Intent, snapshots: dict,
                nodes: dict, gates: dict, now: float,
                pass_claims: list[int] | None = None) -> dict:
        tenant = f"{namespace}/{pod_name}"
        decision = {"at": now, "tenant": tenant, "namespace": namespace, "pod": pod_name,
                    "from_chips": intent.desired_chips, "action": "hold", "reason": "steady",
                    "gates": gates, "trace_id": trace.current_trace_id()}

        def hold(reason: str) -> dict:
            decision["reason"] = reason
            AUTOSCALE_SKIPS.inc(outcome=reason)
            self._streaks.pop(tenant, None)
            return decision

        fit = self.model.fit(tenant, now=now)
        decision["fit"] = fit
        if fit["verdict"] != "ok":
            return hold({"stale": "stale-telemetry", "sparse": "sparse-telemetry",
                         "untracked": "untracked"}.get(fit["verdict"], "error"))
        snap = snapshots.get(tenant) or {}
        queue = float(snap.get("queue_depth") or 0.0)
        util = float(fit.get("utilization", 0.0))
        decision["queue_depth"] = queue
        decision["utilization"] = util
        wants_grow = (queue >= float(self.cfg.autoscale_queue_grow)
                      and util >= float(self.cfg.autoscale_util_grow))
        wants_shrink = (queue <= float(self.cfg.autoscale_queue_shrink)
                        and util <= float(self.cfg.autoscale_util_shrink))
        if not wants_grow and not wants_shrink:
            return hold("steady")
        direction = "grow" if wants_grow else "shrink"
        streaks = self._streaks.setdefault(tenant, {"grow": 0, "shrink": 0})
        # N passes in a row, not N ever: a flipped signal resets the other
        streaks["grow" if wants_shrink else "shrink"] = 0
        streaks[direction] += 1
        decision["streak"] = streaks[direction]
        if streaks[direction] < int(self.cfg.autoscale_hysteresis):
            decision["reason"] = "hysteresis"
            AUTOSCALE_SKIPS.inc(outcome="hysteresis")
            return decision
        last = self._cooldowns.get(tenant)
        if last is not None and now - last < float(self.cfg.autoscale_cooldown_s):
            decision["reason"] = "cooldown"
            decision["cooldown_remaining_s"] = round(
                float(self.cfg.autoscale_cooldown_s) - (now - last), 1)
            AUTOSCALE_SKIPS.inc(outcome="cooldown")
            return decision
        step = max(1, int(self.cfg.autoscale_max_step))
        if direction == "grow":
            target = min(intent.desired_chips + step, int(self.cfg.max_gpu_per_request))
            if target <= intent.desired_chips:
                return hold("at-ceiling")
            feas = self._grow_feasibility(target - intent.desired_chips, nodes,
                                          claims=pass_claims)
            decision["feasibility"] = feas
            if feas["verdict"] == "infeasible":
                return hold("infeasible")
            if feas["verdict"] == "admissible-after-defrag":
                # deferred: the defragmenter works on the host, and the next
                # pass evaluates against what it recovered
                self._request_defrag(tenant, target - intent.desired_chips)
                decision["reason"] = "infeasible"
                decision["deferred"] = "requested-defrag"
                AUTOSCALE_SKIPS.inc(outcome="infeasible")
                return decision
        else:
            target = max(intent.desired_chips - step, max(1, intent.min_chips))
            if target >= intent.desired_chips:
                return hold("at-floor")
        return self._actuate(decision, namespace, pod_name, intent, target, direction, now)

    def _actuate(self, decision: dict, namespace: str, pod_name: str, intent: Intent,
                 target: int, direction: str, now: float) -> dict:
        tenant = decision["tenant"]
        try:
            self.elastic.store.put(namespace, pod_name,
                                   Intent(desired_chips=target, min_chips=intent.min_chips,
                                          priority=intent.priority))
            self.elastic.enqueue(namespace, pod_name)
        except Exception as exc:  # noqa: BLE001 — a failed write is a recorded hold;
            # the streak survives, so the next pass tries again
            decision["action"] = "hold"
            decision["reason"] = "error"
            decision["error"] = str(exc)
            AUTOSCALE_SKIPS.inc(outcome="error")
            logger.warning("autoscale %s of %s failed to write intent: %s", direction, tenant,
                           exc)
            return decision
        decision["action"] = direction
        decision["to_chips"] = target
        decision["reason"] = "saturated-queue" if direction == "grow" else "idle-capacity"
        self._cooldowns[tenant] = now
        self._streaks.pop(tenant, None)
        AUTOSCALE_DECISIONS.inc(outcome=direction)
        summary = (f"autoscale {direction} {tenant}: {decision['from_chips']} -> {target} "
                   f"chip(s) (queue {decision['queue_depth']:.0f}, utilization "
                   f"{decision['utilization']:.2f})")
        AUDIT.record("autoscale.decision", actor="autoscale-controller",
                     outcome=f"{direction}: {decision['from_chips']} -> {target}",
                     namespace=namespace, pod=pod_name, action=direction,
                     from_chips=decision["from_chips"], to_chips=target,
                     queue_depth=decision["queue_depth"], utilization=decision["utilization"],
                     trace_id=decision["trace_id"])
        FLIGHT.record("marker", summary, trace_id=decision["trace_id"] or "")
        logger.info("%s", summary)
        return decision

    # --- pause and resume ---

    def pause(self, actor: str = "operator") -> dict:
        """Stop deciding (idempotent): a pass in flight parks at the next
        tenant boundary; the reads go on."""
        self._paused.set()
        AUTOSCALE_PAUSED.set(1.0)
        AUDIT.record("autoscale.pause", actor=actor, outcome="paused")
        FLIGHT.record("marker", f"autoscale paused by {actor}")
        return self.payload()

    def resume(self, actor: str = "operator") -> dict:
        self._paused.clear()
        AUTOSCALE_PAUSED.set(0.0)
        AUDIT.record("autoscale.resume", actor=actor, outcome="resumed")
        FLIGHT.record("marker", f"autoscale resumed by {actor}")
        return self.payload()

    @property
    def paused(self) -> bool:
        return self._paused.is_set()

    # --- the pane ---

    def payload(self) -> dict:
        """GET /autoscale: the gates, the model's fits, the last pass, the
        recent decisions and the running cooldowns."""
        gates = self._gate_state()
        now = self.clock()
        cooldown_s = float(self.cfg.autoscale_cooldown_s)
        with self._lock:
            last = copy.deepcopy(self._last_pass)
            history = [copy.deepcopy(r) for r in self._history]
            cooldowns = {t: round(cooldown_s - (now - at), 1)
                         for t, at in self._cooldowns.items() if now - at < cooldown_s}
        decisions = [d for r in history for d in r["decisions"]
                     if d["action"] in ("grow", "shrink")]
        return {"at": round(now, 3), "enabled": bool(self.cfg.autoscale_enabled),
                "paused": gates["paused"], "gates": gates, "model": self.model.payload(now=now),
                "last_pass": last, "decisions": decisions[-16:], "cooldowns": cooldowns}

    # --- the loop (under TPUMOUNTER_AUTOSCALE) ---

    def start(self) -> None:
        if self._loop_thread is not None:
            return
        self._stop.clear()
        self._loop_thread = threading.Thread(target=self._loop, name="autoscale-loop",
                                             daemon=True)
        self._loop_thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._loop_thread
        if thread is not None:
            thread.join(timeout=5.0)
        self._loop_thread = None

    def _loop(self) -> None:
        while not self._stop.wait(float(self.cfg.autoscale_interval_s)):
            try:
                self.evaluate_once()
            except AutoscaleRefused as exc:
                logger.info("autoscale pass parked: %s (%s)", exc, exc.cause)
            except Exception as exc:  # noqa: BLE001 — one bad pass never ends the loop
                logger.exception("autoscale pass failed: %s", exc)
