"""The defrag controller: plan, gate and drive the capacity-recovery moves.

The counterpart of ``gpumounter_tpu/defrag/controller.py``. One a master,
built by ``MasterApp`` after the recovery controller. It owns the policy the
planner leaves out:

  * gates: no plan is computed, and no run started or continued, while the
    Kubernetes API is degraded (``ApiHealth``) or the
    ``tenant-migration-downtime`` or ``slice-feasibility`` objective burns
    (``obs/slo.py``); an SLO engine that fails reads as burning (fail
    closed: the defragmenter is optional recovery, not a liveness path);
  * the shards: a sharded replica plans over the nodes it owns, and each
    move's fencing epoch rides the migration machine's own stamps;
  * execution: each move is a live migration with the checkpoint-assisted
    drain (``MigrationCoordinator.begin(..., checkpoint=True)``); after each
    batch of groups the capacity is collected again and the fleet's
    fragmentation index sampled (the barriers of chaos invariant 18), and a
    run that moved anything stamps ``capacity.recovered``
    (``CapacityPlane.record_recovery``);
  * a ``defrag.plan`` span a plan, a ``defrag.run`` span a run and a
    ``defrag.group`` span a group under it, each move's migration in the
    run's trace; the ``defrag.*`` audit records, the flight recorder's
    markers and the ``tpumounter_defrag_*`` series.

Destinations: a move's target pod is a standby the operator provisioned, a
Running pod on the destination node annotated ``tpumounter.io/defrag-dest``.
Without one on the planned node the move is recorded as blocked and the run
stops; the controller never invents a destination. The annotation keys are
the reference's, since they are persisted contracts.
"""

from __future__ import annotations

import copy
import secrets
import statistics
import threading
import time
from collections import deque
from concurrent import futures

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.defrag.planner import PlanError, plan_moves
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.k8s.errors import is_outage
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.migrate.journal import migration_active
from gpumounter_tpu_torch.obs import trace
from gpumounter_tpu_torch.obs.audit import AUDIT
from gpumounter_tpu_torch.obs.flight import FLIGHT
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("defrag")

#: the standby destination's marker (an annotation, any value): a moved
#: tenant is mounted only into a pod that opted in
ANNOT_DEFRAG_DEST = "tpumounter.io/defrag-dest"

#: the slave pod's owner annotations (``allocator/allocator.py``)
ANNOT_OWNER = "tpumounter.io/owner"
ANNOT_OWNER_NAMESPACE = "tpumounter.io/owner-namespace"

#: the objectives whose burn parks the controller
GATING_OBJECTIVES = ("tenant-migration-downtime", "slice-feasibility")

DEFRAG_PLANS = REGISTRY.counter(
    "tpumounter_defrag_plans_total",
    "Defrag plans computed (including empty no-op plans)")
DEFRAG_MOVES = REGISTRY.counter(
    "tpumounter_defrag_moves_total",
    "Defrag moves executed, by migration outcome")
DEFRAG_REFUSALS = REGISTRY.counter(
    "tpumounter_defrag_refusals_total",
    "Plans/runs refused, by bounded cause vocabulary")
DEFRAG_RUNNING = REGISTRY.gauge(
    "tpumounter_defrag_running",
    "1 while a defrag run is executing moves")


class DefragRefused(Exception):
    """A gate's or the staleness rule's refusal, with its HTTP status. The
    causes: stale-snapshot | slo-burn | api-degraded | no-plan | busy."""

    def __init__(self, message: str, cause: str, status: int = 409):
        super().__init__(message)
        self.cause = cause
        self.status = status


class DefragController:
    """All state in memory: a restarted master plans again from a fresh
    snapshot (plans are cheap), while each move's migration journal
    recovers through the migration machine."""

    def __init__(self, kube, migrations, capacity, fleet, slo=None, apihealth=None,
                 shards=None, cfg=None, health=None):
        self.cfg = cfg or Config()
        self.kube = kube
        self.migrations = migrations
        self.capacity = capacity
        self.fleet = fleet
        self.slo = slo
        self.apihealth = apihealth
        self.shards = shards
        #: the health plane: its quarantined hosts are no move's destination
        #: (``excluded_hosts`` is empty when the plane breaks, so a broken
        #: plane never blocks planning)
        self.health = health
        self._lock = OrderedLock("defrag.state")
        self._plan: dict | None = None
        self._run: dict | None = None          # the run in flight
        self._history: deque[dict] = deque(maxlen=32)
        self._pause = threading.Event()
        self._run_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._loop_thread: threading.Thread | None = None

    # --- gates ---

    def _gate_state(self) -> dict:
        burning = []
        if self.slo is not None:
            try:
                evaluation = self.slo.evaluate()
            except Exception as exc:  # noqa: BLE001 — fail closed
                logger.warning("slo evaluation for defrag gate failed: %s", exc)
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
                "slo_burning": burning}

    def _check_gates(self, action: str) -> dict:
        gates = self._gate_state()
        if not gates["api_ok"]:
            self._refuse(action, "api-degraded",
                         f"k8s api is {gates['api_state']}; the defragmenter parks until "
                         f"it heals", 503)
        if gates["slo_burning"]:
            self._refuse(action, "slo-burn",
                         f"SLO burning: {', '.join(gates['slo_burning'])}; refusing to add "
                         f"migration disruption on top of it", 503)
        return gates

    def _refuse(self, action: str, cause: str, message: str, status: int = 409) -> None:
        DEFRAG_REFUSALS.inc(outcome=cause)
        AUDIT.record(f"defrag.{action}", actor="defrag-controller",
                     outcome=f"refused: {cause}", cause=cause, detail=message)
        raise DefragRefused(message, cause, status)

    # --- the cost model ---

    def _cost_fn(self):
        """Seconds a move, from the migration history: a tenant's last
        succeeded migration's phase times summed (its assembled trace's wall
        time where the journal has none), else the fleet's median of those,
        scaled by the GPUs moved."""
        per_tenant: dict[str, float] = {}
        totals: list[float] = []
        try:
            journals = self.migrations.list_migrations()
        except Exception as exc:  # noqa: BLE001 — the flat default then
            logger.warning("migration history for cost model unavailable: %s", exc)
            journals = []
        for journal in journals:
            if journal.get("outcome") != "succeeded":
                continue
            durations = journal.get("phase_durations_s") or {}
            total = sum(float(v) for v in durations.values())
            if not total and journal.get("trace_id"):
                try:
                    from gpumounter_tpu_torch.obs import assembly
                    assembled = assembly.assemble(journal["trace_id"])
                    if assembled:
                        total = float(assembled.get("wall_ms", 0.0)) / 1000.0
                except Exception:  # noqa: BLE001 — a backfill only
                    total = 0.0
            if not total:
                continue
            src = journal.get("source") or {}
            tenant = f"{src.get('namespace')}/{src.get('pod')}"
            per_tenant[tenant] = total
            totals.append(total)
        fleet_median = statistics.median(totals) if totals else 1.0

        def cost(tenant: str, n_gpus: int) -> float:
            base = per_tenant.get(tenant)
            if base is not None:
                return base
            return fleet_median * max(1, n_gpus)
        return cost

    def _resolve_tenants(self, nodes: dict) -> dict:
        """The capacity section's ``held`` names the booking holder, for a
        GPU mounted through a slave pod the slave. Each holder is rewritten
        to its owner (the slave's owner annotations), so that plans, budgets
        and the cost model name tenants the migration machine can move. A
        holder that does not resolve stays as it is, and its move fails at
        admission."""
        cache: dict[str, str] = {}
        resolved: dict[str, dict] = {}
        for node, entry in nodes.items():
            cap = entry.get("capacity") if isinstance(entry, dict) else None
            if not isinstance(cap, dict) or not isinstance(cap.get("held"), dict):
                resolved[node] = entry
                continue
            entry = dict(entry)
            entry["capacity"] = dict(cap)
            entry["capacity"]["held"] = {index: self._owner_of(holder, cache)
                                         for index, holder in cap["held"].items()}
            resolved[node] = entry
        return resolved

    def _owner_of(self, holder, cache: dict[str, str]) -> str:
        holder = str(holder)
        if holder in cache:
            return cache[holder]
        namespace, _, pod_name = holder.partition("/")
        owner = holder
        try:
            pod = Pod(self.kube.get_pod(namespace, pod_name))
        except Exception as exc:  # noqa: BLE001 — the booking name then
            (logger.debug if is_outage(exc) else logger.info)(
                "holder %s unresolvable (%s); planning against the booking name", holder, exc)
        else:
            owner_ns = pod.annotations.get(ANNOT_OWNER_NAMESPACE)
            owner_name = pod.annotations.get(ANNOT_OWNER)
            if owner_ns and owner_name:
                owner = f"{owner_ns}/{owner_name}"
        cache[holder] = owner
        return owner

    # --- planning ---

    def plan(self, target_block: int | None = None) -> dict:
        """Compute and adopt a plan from a fresh capacity snapshot. A gate
        raises DefragRefused; a plan with no move is returned (a fleet with
        nothing blocked is a fine state)."""
        with trace.span("defrag.plan"):
            self._check_gates("plan")
            target = int(target_block or self.cfg.defrag_target_block)
            max_age = float(self.cfg.defrag_snapshot_max_age_s)
            try:
                rollup = self.fleet.payload(max_age_s=max_age)
            except Exception as exc:  # noqa: BLE001 — no snapshot to trust:
                # refused as a stale one
                self._refuse("plan", "stale-snapshot",
                             f"capacity collection failed "
                             f"({'api outage' if is_outage(exc) else exc}); refusing to "
                             f"plan blind", 503)
            nodes = rollup.get("nodes") or {}
            if self.shards is not None and self.shards.active():
                nodes = {n: e for n, e in nodes.items() if self.shards.owns_node(n)}
            nodes = self._resolve_tenants(nodes)
            try:
                plan = plan_moves(
                    nodes,
                    target_block=target,
                    max_moves=int(self.cfg.defrag_max_moves),
                    tenant_move_budget=int(self.cfg.defrag_tenant_move_budget),
                    snapshot_at=rollup.get("at"),
                    max_snapshot_age_s=max_age,
                    now=time.time(),
                    non_destinations=(self.health.excluded_hosts()
                                      if self.health is not None else frozenset()),
                    cost_fn=self._cost_fn())
            except PlanError as exc:
                self._refuse("plan", exc.cause, str(exc), exc.status)
            plan["id"] = f"dfp-{secrets.token_hex(4)}"
            plan["created_at"] = time.time()
            if self.shards is not None and self.shards.active():
                # the fencing epoch each source node's moves will carry
                plan["epochs"] = {m["source_node"]: self.shards.node_epoch(m["source_node"])
                                  for m in plan["moves"]}
            with self._lock:
                self._plan = plan
            DEFRAG_PLANS.inc()
            summary = (f"defrag plan {plan['id']}: {len(plan['moves'])} move(s) over "
                       f"{len(plan['groups'])} host(s), fragmentation "
                       f"{plan['fragmentation_before']} -> {plan['fragmentation_after']} "
                       f"(predicted)")
            AUDIT.record("defrag.plan", actor="defrag-controller",
                         outcome=f"planned: {len(plan['moves'])} move(s)",
                         plan_id=plan["id"], moves=len(plan["moves"]), target_block=target,
                         fragmentation_before=plan["fragmentation_before"],
                         fragmentation_after=plan["fragmentation_after"])
            FLIGHT.record("marker", summary, plan_id=plan["id"])
            logger.info("%s", summary)
            return copy.deepcopy(plan)

    # --- running ---

    def run(self, plan_id: str | None = None, wait: bool = False) -> dict:
        """Execute the adopted plan (`plan_id`, when given, must be it). The
        gates are checked now and before every batch. The moves run on a
        thread of their own unless `wait` (the tests, the loop)."""
        self._check_gates("run")
        with self._lock:
            if self._run_thread is not None and self._run_thread.is_alive():
                self._refuse("run", "busy", "a defrag run is already executing", 409)
            plan = self._plan
            if plan is None:
                self._refuse("run", "no-plan", "no adopted plan; POST /defrag/plan first", 409)
            if plan_id is not None and plan["id"] != plan_id:
                self._refuse("run", "no-plan", f"adopted plan is {plan['id']}, not {plan_id}",
                             409)
            age = time.time() - float(plan["created_at"])
            bound = float(self.cfg.defrag_snapshot_max_age_s)
            if age > bound:
                self._plan = None
                self._refuse("run", "stale-snapshot",
                             f"plan {plan['id']} is {age:.1f}s old (bound {bound:.0f}s); "
                             f"the fleet has moved on — re-plan", 409)
            plan = copy.deepcopy(plan)
            self._pause.clear()
            self._run = {"plan_id": plan["id"], "status": "running",
                         "started_at": time.time(), "moves": [], "barriers": [],
                         "trace_id": None}
        if wait:
            self._execute(plan)
            return self.payload()
        thread = threading.Thread(target=self._execute, args=(plan,),
                                  name=f"defrag-{plan['id']}", daemon=True)
        with self._lock:
            self._run_thread = thread
        thread.start()
        return self.payload()

    def pause(self) -> dict:
        """Stop after the move in flight; idempotent."""
        self._pause.set()
        AUDIT.record("defrag.pause", actor="defrag-controller", outcome="pause requested")
        return self.payload()

    def _barrier(self, run: dict, label: str) -> float | None:
        """Collect the capacity again and sample the fleet's fragmentation
        index: one of the plan's barriers."""
        try:
            payload = self.capacity.payload(max_age_s=0.0)
            index = float(payload["fleet"]["fragmentation_index"])
        except Exception as exc:  # noqa: BLE001 — recorded; the run's verdict
            # does not depend on it
            logger.warning("defrag barrier capacity sample failed: %s", exc)
            run["barriers"].append({"label": label, "error": str(exc)})
            return None
        run["barriers"].append({"label": label, "at": time.time(),
                                "fragmentation_index": index})
        FLIGHT.record("marker",
                      f"defrag {run['plan_id']} barrier {label}: fragmentation index {index}",
                      plan_id=run["plan_id"])
        return index

    def _execute(self, plan: dict) -> None:
        with trace.span("defrag.run", plan_id=plan["id"]):
            self._execute_traced(plan)

    def _execute_traced(self, plan: dict) -> None:
        run = self._run
        run["trace_id"] = trace.current_trace_id()
        DEFRAG_RUNNING.set(1.0)
        frag_before = None
        succeeded = 0
        try:
            failpoints.fire("defrag.run", plan_id=plan["id"])
            frag_before = self._barrier(run, "start")
            by_group: dict[str, list[dict]] = {}
            for move in plan["moves"]:
                by_group.setdefault(move["group"], []).append(move)
            # groups whose hosts (the source and every destination) are
            # disjoint share no GPU, standby or kubelet, so they run at once,
            # at most defrag_group_fanout; the gates and the pause are read
            # between batches, and the barriers sample after a batch, a
            # quiescent fleet
            aborted = False
            for batch in self._disjoint_batches(plan["groups"], by_group):
                if self._pause.is_set():
                    run["status"] = "paused"
                    aborted = True
                    break
                gates = self._gate_state()
                if not gates["api_ok"]:
                    run["status"] = "parked-api"
                    run["parked"] = gates["api_state"]
                    DEFRAG_REFUSALS.inc(outcome="api-degraded")
                    aborted = True
                    break
                if gates["slo_burning"]:
                    run["status"] = "parked-slo"
                    run["parked"] = gates["slo_burning"]
                    DEFRAG_REFUSALS.inc(outcome="slo-burn")
                    aborted = True
                    break
                batch_ok, batch_succeeded = self._run_batch(run, batch, by_group)
                succeeded += batch_succeeded
                for group in batch:
                    self._barrier(run, group["node"])
                if not batch_ok:
                    run["status"] = "failed-move"
                    aborted = True
                    break
            if not aborted and run["status"] == "running":
                run["status"] = "completed"
        except Exception as exc:  # noqa: BLE001 — the run reaches the history
            # with a truthful status
            logger.exception("defrag run %s died: %s", plan["id"], exc)
            run["status"] = "failed"
            run["error"] = f"{type(exc).__name__}: {exc}"
        finally:
            DEFRAG_RUNNING.set(0.0)
            run["finished_at"] = time.time()
            frag_after = self._barrier(run, "end")
            if succeeded and frag_before is not None and frag_after is not None:
                # what the run bought back, over the rollup the barrier
                # above refreshed
                self.capacity.record_recovery(
                    cause="defrag", plan_id=plan["id"], fragmentation_before=frag_before,
                    fragmentation_after=frag_after, moves=succeeded)
            AUDIT.record("defrag.run", actor="defrag-controller",
                         outcome=f"{run['status']}: {succeeded}/{len(plan['moves'])} move(s)",
                         plan_id=plan["id"], status=run["status"],
                         moves_succeeded=succeeded, moves_planned=len(plan["moves"]))
            FLIGHT.record("marker",
                          f"defrag run {plan['id']} {run['status']}: {succeeded}/"
                          f"{len(plan['moves'])} move(s)", plan_id=plan["id"])
            with self._lock:
                self._history.append(copy.deepcopy(run))
                self._run = None
                self._run_thread = None
                if self._plan is not None and self._plan["id"] == plan["id"]:
                    self._plan = None  # consumed, on a failure too

    def _disjoint_batches(self, groups: list[dict],
                          by_group: dict[str, list[dict]]) -> list[list[dict]]:
        """The plan's groups, in order, cut into batches of consecutive
        groups whose hosts (the source and every move's destination) are
        pairwise disjoint, at most defrag_group_fanout a batch. The order is
        the planner's ranking and is kept."""
        fanout = max(1, int(self.cfg.defrag_group_fanout))

        def hosts_of(group: dict) -> set[str]:
            hosts = {group["node"]}
            for move in by_group.get(group["node"], []):
                hosts.add(move["source_node"])
                hosts.add(move["dest_node"])
            return hosts

        batches: list[list[dict]] = []
        batch: list[dict] = []
        batch_hosts: set[str] = set()
        for group in groups:
            hosts = hosts_of(group)
            if batch and (len(batch) >= fanout or batch_hosts & hosts):
                batches.append(batch)
                batch, batch_hosts = [], set()
            batch.append(group)
            batch_hosts |= hosts
        if batch:
            batches.append(batch)
        return batches

    def _run_batch(self, run: dict, batch: list[dict],
                   by_group: dict[str, list[dict]]) -> tuple[bool, int]:
        """One batch of host-disjoint groups, at once when it holds more than
        one; a group's own moves run in turn (they share the source's
        kubelet and the standbys). (every move succeeded, the count that
        did)."""

        def run_group(group: dict) -> tuple[bool, int]:
            ok, done = True, 0
            with trace.span("defrag.group", node=group["node"]):
                for move in by_group.get(group["node"], []):
                    if self._execute_move(run, move) == "succeeded":
                        done += 1
                    else:
                        ok = False
                        break
            return ok, done

        if len(batch) == 1:
            return run_group(batch[0])
        ctx = trace.current()

        def traced(group: dict) -> tuple[bool, int]:
            # a context variable does not cross threads: the run's trace is
            # attached again, so each move's spans join it
            with trace.attached(ctx):
                return run_group(group)

        with futures.ThreadPoolExecutor(max_workers=len(batch),
                                        thread_name_prefix="defrag-group") as pool:
            results = list(pool.map(traced, batch))
        return all(ok for ok, _ in results), sum(done for _, done in results)

    def _execute_move(self, run: dict, move: dict) -> str:
        """One live migration with the checkpoint-assisted drain. The
        migration's outcome ("succeeded", ...), or the controller's own
        when no standby exists or the admission refuses."""
        record = {"namespace": move["namespace"], "pod": move["pod"],
                  "source_node": move["source_node"], "dest_node": move["dest_node"],
                  "chips": move["chips"]}
        run["moves"].append(record)
        dest = self._resolve_destination(move)
        if dest is None:
            record["outcome"] = "blocked-no-destination"
            DEFRAG_MOVES.inc(outcome="blocked")
            logger.warning("defrag %s: no standby destination pod on %s (annotate a Running "
                           "pod with %s); move of %s/%s blocked", run["plan_id"],
                           move["dest_node"], ANNOT_DEFRAG_DEST, move["namespace"], move["pod"])
            return "blocked-no-destination"
        dest_ns, dest_pod = dest
        record["dest_pod"] = f"{dest_ns}/{dest_pod}"
        try:
            journal = self.migrations.begin(move["namespace"], move["pod"], dest_ns, dest_pod,
                                            checkpoint=True)
        except Exception as exc:  # noqa: BLE001 — the admission's refusal
            record["outcome"] = "rejected"
            record["error"] = str(exc)
            DEFRAG_MOVES.inc(outcome="rejected")
            return "rejected"
        record["migration_id"] = journal["id"]
        record["trace_id"] = journal.get("trace_id")
        final = self.migrations.wait(journal["id"], timeout_s=600.0)
        outcome = (final or {}).get("outcome") or "unknown"
        record["outcome"] = outcome
        if final is not None:
            record["downtime_s"] = final.get("downtime_s")
            record["phases"] = final.get("phase_durations_s")
            record["checkpointed"] = final.get("checkpointed")
        DEFRAG_MOVES.inc(outcome=outcome)
        return outcome

    def _resolve_destination(self, move: dict) -> tuple[str, str] | None:
        """The standby on the destination node: Running, annotated
        ANNOT_DEFRAG_DEST, in the tenant's namespace, not in a migration.
        The first by name, so a run again converges on the same one."""
        try:
            listed = self.kube.list_pods(move["namespace"])
        except Exception as exc:  # noqa: BLE001 — no destination: the run
            # stops rather than guess
            logger.warning("standby listing on %s failed (%s): %s", move["dest_node"],
                           "api outage" if is_outage(exc) else "api error", exc)
            return None
        candidates = []
        for raw in listed:
            pod = Pod(raw)
            if pod.node_name != move["dest_node"]:
                continue
            if ANNOT_DEFRAG_DEST not in pod.annotations:
                continue
            if pod.name == move["pod"] and pod.namespace == move["namespace"]:
                continue
            if (pod.phase or "").lower() != "running":
                continue
            if migration_active(pod.annotations):
                continue
            candidates.append((pod.namespace, pod.name))
        return min(candidates) if candidates else None

    # --- the surfaces ---

    def payload(self) -> dict:
        """The GET /defrag answer."""
        gates = self._gate_state()
        with self._lock:
            plan = copy.deepcopy(self._plan)
            run = copy.deepcopy(self._run)
            history = [copy.deepcopy(r) for r in self._history]
        return {
            "at": round(time.time(), 3),
            "enabled": bool(self.cfg.defrag_enabled),
            "gates": gates,
            "plan": plan,
            "run": run,
            "history": history[-8:],
        }

    # --- the background loop (TPUMOUNTER_DEFRAG) ---

    def start(self) -> None:
        if self._loop_thread is not None:
            return
        self._stop.clear()
        self._loop_thread = threading.Thread(target=self._loop, name="defrag-loop",
                                             daemon=True)
        self._loop_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._pause.set()
        thread, runner = self._loop_thread, self._run_thread
        if thread is not None:
            thread.join(timeout=5.0)
        if runner is not None:
            runner.join(timeout=5.0)
        self._loop_thread = None

    def _loop(self) -> None:
        while not self._stop.wait(float(self.cfg.defrag_interval_s)):
            try:
                plan = self.plan()
                if plan["moves"]:
                    self.run(plan["id"], wait=True)
            except DefragRefused as exc:
                logger.info("defrag background pass parked: %s (%s)", exc, exc.cause)
            except Exception as exc:  # noqa: BLE001 — one bad pass must not
                # end the loop
                logger.exception("defrag background pass failed: %s", exc)
