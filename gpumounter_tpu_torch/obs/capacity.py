"""The capacity plane: free GPUs, in what shapes, and which sizes place now.

The counterpart of ``gpumounter_tpu/obs/capacity.py``, in its NVSwitch form.
The reference's plane is ICI geometry: a host's free chips fall into
components of the 2-wide grid, and a block of k chips exists only inside a
component of k or more. Every pair of GPUs of an H100 host is joined by
NVSwitch (``topology.py``), so any set of free GPUs on a host is one block.
The port takes the reference's formulas with that block; everything follows:

  * ``node_capacity_snapshot`` (the worker half): the host's GPUs by index,
    free / held / warm / fenced, the ``capacity`` section of the
    CollectTelemetry snapshot. A GPU the backend's probe finds unhealthy is
    fenced whoever books it; a healthy booked GPU is warm when the warm
    pool's ready book holds its holder (never the name's prefix), held
    otherwise; the rest is free. The scrape fallback's section is None.
  * ``host_capacity``: one host's view. ``largest_block`` is the number of
    free GPUs, so the host's fragmentation index ``1 - largest / free`` is
    0, and a host block size of 1, 2, 4 or 8 GPUs (``HOST_BLOCK_SIZES``, the
    H100 host's vocabulary as the v5e host's) is admissible when that many
    GPUs are free. The reference's ``best_block`` (``allocator/placement.py``,
    which the port leaves out) is not named: no free GPU is a better pick.
  * ``CapacityPlane`` (the master half): every node's inventory rolled into
    the fleet's (its weighted index 0 too), a feasibility table over
    ``topology.FEASIBILITY_SHAPES`` (admissible now; admissible-after-defrag
    when the free and warm GPUs reach the shape's GPUs a host but the free
    ones alone do not, which on NVSwitch only warm holders can cause;
    infeasible), the headroom against the tenants' queue depth and tokens/s,
    the declared intents' demand, and the shares' fractional view. Served at
    GET /capacity; its ``observe`` feeds the slice-feasibility SLO's two
    counters on every fleet pass.
  * ``record_rejection`` stamps the verdict of an add refused for capacity
    (``capacity.reject``) into the audit trail, and so onto the flight
    recorder's timeline; ``record_recovery`` (``capacity.recovered``) closes
    the loop after a defragmentation.

Every JSON key, verdict string, audit kind and series name is the
reference's, since the CLI and the defragmenter read them. GPU indices ride
the JSON plane only, never a metric's labels. The standard library and the
port's ``utils/`` and ``obs/`` only, with the config and the topology's
shapes read where they are needed: the worker imports the snapshot half on
its telemetry path.
"""

from __future__ import annotations

import time
from collections import deque

from gpumounter_tpu_torch.obs.audit import AUDIT
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("obs.capacity")

CAPACITY_SCHEMA = "tpumounter-capacity/1"

#: the GPUs-a-host vocabulary of the feasibility shapes: an A3 host's sizes
HOST_BLOCK_SIZES = (1, 2, 4, 8)

# fleet-level series only: the per-node numbers ride /capacity
CAPACITY_FREE_CHIPS = REGISTRY.gauge(
    "tpumounter_capacity_free_chips",
    "Free (healthy, unbooked) chips across the last capacity rollup")
CAPACITY_FRAG_INDEX = REGISTRY.gauge(
    "tpumounter_capacity_fragmentation_index",
    "Fleet ICI fragmentation index: 1 - achievable-contiguous / free "
    "(0 = perfectly defragmented, -> 1 = scattered)")
CAPACITY_SIZE_FEASIBLE = REGISTRY.counter(
    "tpumounter_capacity_size_feasible_total",
    "Per-collection-pass accelerator-size feasibility evaluations NOT "
    "denied by fragmentation: admissible now, or out of reach for raw "
    "free capacity (utilization — capacity planning's problem, not a "
    "page). The slice-feasibility SLO's good events")
CAPACITY_SIZE_INFEASIBLE = REGISTRY.counter(
    "tpumounter_capacity_size_infeasible_total",
    "Per-collection-pass accelerator-size feasibility evaluations "
    "where the free chips EXIST but ICI fragmentation denies placement "
    "(admissible-after-defrag) — the slice-feasibility SLO's bad "
    "events and the defragmenter's work signal")


def _default_config():
    from gpumounter_tpu_torch.config import Config
    return Config()


# --- the worker half ---


def node_capacity_snapshot(collector, pool=None, cfg=None) -> dict:
    """This worker's GPUs, classified free / held / warm / fenced by index:
    the ``capacity`` section of the CollectTelemetry snapshot. A kubelet
    that fails the ownership refresh keeps the last marks and reads
    ``ownership_known`` false, as the reference's degraded collector does:
    it never fails the telemetry answer."""
    cfg = cfg or _default_config()
    known = bool(getattr(collector, "ownership_known", True))
    try:
        collector.update_status()
    except Exception as exc:  # noqa: BLE001 — the marks of the last refresh stand
        logger.warning("capacity snapshot: ownership refresh failed: %s", exc)
        known = False
    devices = collector.snapshot()
    node = getattr(cfg, "node_name", "") or ""
    ready: set[str] = set()
    if pool is not None and getattr(pool, "enabled", False):
        ready = set(pool.ready_names(node))
    free: list[int] = []
    warm: list[int] = []
    fenced: list[int] = []
    held: dict[str, str] = {}
    for dev in devices:
        healthy, _reason = collector.backend.probe_device(dev)
        if not healthy:
            fenced.append(dev.index)
        elif not dev.pod_name:
            free.append(dev.index)
        elif dev.namespace == cfg.pool_namespace and dev.pod_name in ready:
            # the pool's ready book alone decides warm: an adopted holder
            # keeps its warm-slave- name (pods are not renamed)
            warm.append(dev.index)
        else:
            held[str(dev.index)] = f"{dev.namespace}/{dev.pod_name}"
    return {
        "schema": CAPACITY_SCHEMA,
        "total": len(devices),
        "free": sorted(free),
        "warm": sorted(warm),
        "fenced": sorted(fenced),
        "held": {k: held[k] for k in sorted(held, key=int)},
        # the pool's own book, so that /capacity and tpumounter_warm_pool_ready
        # describe one number
        "warm_ready": pool.ready_count(node) if pool is not None and node else len(warm),
        "ownership_known": known,
    }


# --- one host's view ---


def largest_block(free: list[int]) -> int:
    """The largest block of free GPUs one mount on the host could take: all
    of them, since NVSwitch joins every pair (the reference's
    ``largest_ici_block`` walks the 2-wide grid's links)."""
    return len(set(free))


def host_capacity(snapshot: dict | None) -> dict:
    """One node's view from its reported section; None (the scrape
    fallback) is capacity_unknown, left out of the fleet's numbers."""
    if not isinstance(snapshot, dict):
        return {"capacity_unknown": True}
    free = sorted(int(i) for i in snapshot.get("free") or [])
    warm = sorted(int(i) for i in snapshot.get("warm") or [])
    fenced = sorted(int(i) for i in snapshot.get("fenced") or [])
    held = snapshot.get("held") or {}
    largest = largest_block(free)
    n_free = len(free)
    return {
        "total": int(snapshot.get("total", 0)),
        "free": n_free,
        "held": len(held),
        "warm": len(warm),
        "fenced": len(fenced),
        "free_indices": free,
        "warm_ready": int(snapshot.get("warm_ready", len(warm))),
        "largest_block": largest,
        "fragmentation_index": round(1.0 - largest / n_free, 4) if n_free else 0.0,
        "admissible_block_sizes": [s for s in HOST_BLOCK_SIZES if s <= largest],
        "ownership_known": bool(snapshot.get("ownership_known", True)),
    }


def _inventory_key(raw: object) -> tuple:
    """A cheap key over a reported section: a pass re-derives only the
    hosts whose key moved."""
    if not isinstance(raw, dict):
        return ("unknown",)
    held = raw.get("held") or {}
    return (raw.get("total"), tuple(raw.get("free") or ()), tuple(raw.get("warm") or ()),
            tuple(raw.get("fenced") or ()), tuple(sorted(held.items())),
            raw.get("warm_ready"), bool(raw.get("ownership_known", True)))


# --- the master's plane ---


class CapacityPlane:
    """The fleet's capacity over the ``FleetCollector``'s node entries: a
    sharded replica's collector pulls the nodes it owns, so /capacity covers
    the slice /fleet does and says which shards."""

    def __init__(self, fleet, cfg=None, elastic=None, shares=None):
        """fleet: a ``FleetCollector`` (``payload(max_age_s=)``). elastic: the
        ``ElasticReconciler`` whose intents are the demand. shares: a
        ``vchip.ShareRegistry``, for the fractional view."""
        self.cfg = cfg or _default_config()
        self.fleet = fleet
        self.elastic = elastic
        self.shares = shares
        self._lock = OrderedLock("capacity.trend")
        #: (wall time, free GPUs, queue depth), one a pass
        self._trend: deque[tuple[float, int, float]] = deque(
            maxlen=max(2, int(self.cfg.capacity_trend_samples)))
        #: node -> (inventory key, derived view); replaced whole each pass
        self._host_cache: dict[str, tuple[tuple, dict]] = {}

    def _derive_hosts(self, nodes: dict[str, dict]) -> dict[str, dict]:
        """Each node's view, re-derived only where its inventory moved. A
        stale node (its worker stopped answering) is capacity_unknown: its
        last free GPUs must not green-light a mount."""
        hosts: dict[str, dict] = {}
        fresh: dict[str, tuple[tuple, dict]] = {}
        for node, entry in nodes.items():
            stale = bool(entry.get("stale"))
            raw = None if stale else entry.get("capacity")
            key = ("stale",) if stale else _inventory_key(raw)
            cached = self._host_cache.get(node)
            if cached is not None and cached[0] == key:
                derived = cached[1]
            else:
                derived = host_capacity(raw)
                if stale:
                    derived["stale"] = True
            fresh[node] = (key, derived)
            hosts[node] = derived
        self._host_cache = fresh
        return hosts

    def observe(self, nodes: dict[str, dict]) -> dict:
        """One collection pass: the fleet's gauges, the slice-feasibility
        counters (bad events are denials that a defragmentation would lift,
        never a full fleet) and the trend. The collector isolates its
        failures."""
        hosts = self._derive_hosts(nodes)
        fleet = self._fleet_rollup(hosts)
        feasibility = self._feasibility(hosts, fleet)
        tracked = [e for e in feasibility.values() if e["tracked"]]
        blocked = sum(1 for e in tracked if e["verdict"] == "admissible-after-defrag")
        if tracked:
            CAPACITY_SIZE_FEASIBLE.inc(float(len(tracked) - blocked))
            CAPACITY_SIZE_INFEASIBLE.inc(float(blocked))
        CAPACITY_FREE_CHIPS.set(float(fleet["free"]))
        CAPACITY_FRAG_INDEX.set(fleet["fragmentation_index"])
        queue_depth = self._queue_depth(nodes)
        with self._lock:
            self._trend.append((time.time(), fleet["free"], queue_depth))
        return {"hosts": hosts, "fleet": fleet, "feasibility": feasibility}

    @staticmethod
    def _fleet_rollup(hosts: dict[str, dict]) -> dict:
        total = free = held = warm = fenced = achievable = largest = reporting = 0
        for entry in hosts.values():
            if entry.get("capacity_unknown"):
                continue
            reporting += 1
            total += entry["total"]
            free += entry["free"]
            held += entry["held"]
            warm += entry["warm"]
            fenced += entry["fenced"]
            achievable += entry["largest_block"]
            largest = max(largest, entry["largest_block"])
        return {
            "hosts": len(hosts),
            "hosts_reporting": reporting,
            "total": total,
            "free": free,
            "held": held,
            "warm": warm,
            "fenced": fenced,
            "largest_block": largest,
            # 1 - the hosts' largest blocks over the free GPUs: 0 on NVSwitch
            "fragmentation_index": round(1.0 - achievable / free, 4) if free else 0.0,
        }

    def _feasibility(self, hosts: dict[str, dict], fleet: dict) -> dict[str, dict]:
        """Each shape of ``topology.FEASIBILITY_SHAPES``: admissible when
        enough hosts hold a free block of its GPUs a host; after a
        defragmentation when the free and warm GPUs of enough hosts reach it
        (warm holders are reclaimable); else infeasible. The hosts in the
        way are named, at most capacity_blocking_hosts_max."""
        from gpumounter_tpu_torch.topology import FEASIBILITY_SHAPES
        name_cap = max(1, int(self.cfg.capacity_blocking_hosts_max))
        reporting = [(node, entry) for node, entry in sorted(hosts.items())
                     if not entry.get("capacity_unknown")]
        by_size: dict[int, tuple[list[str], list[str]]] = {}
        for cph in {t.gpus_per_host for t in FEASIBILITY_SHAPES.values()}:
            now: list[str] = []
            after: list[str] = []
            for node, entry in reporting:
                if entry["largest_block"] >= cph:
                    now.append(node)
                elif entry["free"] + entry["warm"] >= cph:
                    after.append(node)
            by_size[cph] = (now, after)
        table: dict[str, dict] = {}
        for accel_type, topo in sorted(FEASIBILITY_SHAPES.items()):
            cph, needed = topo.gpus_per_host, topo.num_hosts
            now, after = by_size[cph]
            if len(now) >= needed:
                verdict, blocking = "admissible", []
            elif len(now) + len(after) >= needed:
                verdict, blocking = "admissible-after-defrag", after[:name_cap]
            else:
                verdict, blocking = "infeasible", after[:name_cap]
            table[accel_type] = {
                "verdict": verdict,
                "chips_per_host": cph,
                "hosts_needed": needed,
                "total_chips": topo.total_gpus,
                "hosts_admissible_now": len(now),
                "hosts_after_defrag": len(now) + len(after),
                "blocking_hosts": blocking,
                # a size the fleet could never hold feeds no SLO
                "tracked": topo.total_gpus <= fleet["total"],
            }
        return table

    def _shares_view(self, hosts: dict[str, dict], fleet: dict) -> dict | None:
        """Free capacity in weight units: a whole free GPU counts the full
        vchip_weight_capacity, a shared one its headroom. A shared GPU on a
        host that is not reporting counts as unknown, never as headroom."""
        if self.shares is None:
            return None
        capacity = int(self.cfg.vchip_weight_capacity)
        view = {"weight_capacity": capacity, "shares": 0, "chips": 0, "booked_weight": 0,
                "share_headroom": 0, "unknown_chips": 0}
        for _uuid, holders in self.shares.shared_chips().items():
            view["shares"] += len(holders)
            entry = hosts.get(holders[0].node)
            if entry is None or entry.get("capacity_unknown"):
                view["unknown_chips"] += 1
                continue
            load = sum(s.weight for s in holders)
            view["chips"] += 1
            view["booked_weight"] += load
            view["share_headroom"] += max(0, capacity - load)
        view["capacity_unknown"] = view["unknown_chips"] > 0
        view["effective_free_weight"] = fleet["free"] * capacity + view["share_headroom"]
        return view

    def blocked_hosts(self, max_age_s: float | None = None) -> frozenset[str]:
        """The hosts that admissible-after-defrag verdicts name: the
        defragmenter's work, a last resort for the share packer, a flag for
        the allocator. Never raises: an error is the empty set."""
        try:
            hosts = self._derive_hosts(self.fleet.payload(max_age_s=max_age_s).get("nodes", {}))
            fleet = self._fleet_rollup(hosts)
            out: set[str] = set()
            for entry in self._feasibility(hosts, fleet).values():
                if entry["verdict"] == "admissible-after-defrag":
                    out.update(entry["blocking_hosts"])
            return frozenset(out)
        except Exception as exc:  # noqa: BLE001 — the hint is advisory
            logger.warning("blocked-host derivation failed: %s", exc)
            return frozenset()

    @staticmethod
    def _queue_depth(nodes: dict[str, dict]) -> float:
        from gpumounter_tpu_torch.obs.fleet import merge_tenants
        depth = 0.0
        for snap in merge_tenants(nodes).values():
            value = snap.get("queue_depth")
            if isinstance(value, (int, float)):
                depth += float(value)
        return depth

    # --- GET /capacity ---

    def payload(self, max_age_s: float | None = None, accel_type: str | None = None) -> dict:
        """The /capacity body over the fleet's rollup (collected first when
        older than max_age_s). `accel_type` keeps one row of the table and
        raises KeyError for an unknown one (the route's 404)."""
        rollup = self.fleet.payload(max_age_s=max_age_s)
        nodes = rollup["nodes"]
        hosts = self._derive_hosts(nodes)
        fleet = self._fleet_rollup(hosts)
        feasibility = self._feasibility(hosts, fleet)
        if accel_type is not None:
            norm = accel_type.strip().lower()
            feasibility = {norm: feasibility[norm]}
        payload = {
            "at": rollup.get("at"),
            "nodes": hosts,
            "fleet": fleet,
            "feasibility": feasibility,
            "headroom": self._headroom(nodes, fleet),
            "demand": self._demand(fleet),
        }
        shares_view = self._shares_view(hosts, fleet)
        if shares_view is not None:
            payload["shares"] = shares_view
        if "shard" in rollup:
            payload["shard"] = rollup["shard"]
        return payload

    def _headroom(self, nodes: dict[str, dict], fleet: dict) -> dict:
        """The free GPUs against the tenants' queue depth and tokens/s, with
        the trend over the trailing passes: ok, tight or exhausted."""
        from gpumounter_tpu_torch.obs.fleet import merge_tenants
        merged = merge_tenants(nodes)
        queue_depth = tokens_per_s = 0.0
        for snap in merged.values():
            value = snap.get("queue_depth")
            if isinstance(value, (int, float)):
                queue_depth += float(value)
            tokens_per_s += float(snap.get("tokens_per_s", 0.0) or 0.0)
        with self._lock:
            trend = list(self._trend)
        trend_out = {"window_s": 0.0, "free_delta": 0, "queue_delta": 0.0}
        if len(trend) >= 2:
            (t0, free0, q0), (t1, free1, q1) = trend[0], trend[-1]
            trend_out = {"window_s": round(t1 - t0, 3), "free_delta": free1 - free0,
                         "queue_delta": round(q1 - q0, 3)}
        free, total = fleet["free"], fleet["total"]
        if total and free == 0:
            forecast = "exhausted"
        elif total and (free / total < float(self.cfg.capacity_tight_free_ratio)
                        or queue_depth > free):
            forecast = "tight"
        else:
            forecast = "ok"
        return {
            "free_chips": free,
            "warm_chips": fleet["warm"],
            "queue_depth": queue_depth,
            "tokens_per_s": round(tokens_per_s, 3),
            "tenants": len(merged),
            "trend": trend_out,
            "forecast": forecast,
        }

    def _demand(self, fleet: dict) -> dict:
        """The declared intents against the free and warm GPUs."""
        intents = desired = actual = 0
        if self.elastic is not None:
            try:
                listed = self.elastic.store.list()
            except Exception as exc:  # noqa: BLE001 — demand is advisory
                logger.warning("intent list for capacity demand failed: %s", exc)
                listed = []
            for namespace, pod_name, intent in listed:
                intents += 1
                desired += int(intent.desired_chips)
                status = self.elastic.status_for(namespace, pod_name)
                if status and isinstance(status.get("actual"), int):
                    actual += status["actual"]
        gap = max(0, desired - actual)
        return {"intents": intents, "desired_chips": desired, "actual_chips": actual,
                "gap": gap, "satisfiable": gap <= fleet["free"] + fleet["warm"]}

    # --- the audit stamps ---

    def record_rejection(self, node: str, namespace: str, pod: str, chips: int) -> dict:
        """An add refused for capacity: the verdict of the last rollup (no
        pass forced) as a ``capacity.reject`` record. On NVSwitch a host's
        block is all its free GPUs, so the cause is exhaustion. Never
        raises."""
        verdict: dict = {"node": node, "want": int(chips)}
        try:
            hosts = self._derive_hosts(self.fleet.payload(max_age_s=None).get("nodes", {}))
            entry = hosts.get(node) or {"capacity_unknown": True}
            fleet = self._fleet_rollup(hosts)
            if entry.get("capacity_unknown"):
                verdict["node_view"] = "unknown"
            else:
                verdict.update(node_free=entry["free"],
                               node_largest_block=entry["largest_block"],
                               node_fragmentation_index=entry["fragmentation_index"])
                if entry["free"] >= int(chips) > entry["largest_block"]:
                    verdict["cause"] = "fragmentation"
                else:
                    verdict["cause"] = "exhaustion"
            verdict["fleet_free"] = fleet["free"]
            verdict["fleet_fragmentation_index"] = fleet["fragmentation_index"]
        except Exception as exc:  # noqa: BLE001 — never masks the refusal itself
            logger.exception("capacity rejection verdict failed: %s", exc)
            verdict["error"] = f"{type(exc).__name__}: {exc}"
        outcome = (f"infeasible: want {chips} chip(s) on {node} "
                   f"(cause: {verdict.get('cause', 'unknown')}, node "
                   f"free {verdict.get('node_free', '?')}, largest "
                   f"block {verdict.get('node_largest_block', '?')}, "
                   f"fleet free {verdict.get('fleet_free', '?')})")
        AUDIT.record("capacity.reject", actor="capacity-plane", namespace=namespace, pod=pod,
                     outcome=outcome, **verdict)
        return verdict

    def record_recovery(self, *, cause: str, plan_id: str, fragmentation_before: float,
                        fragmentation_after: float, moves: int) -> dict:
        """What a finished defragmentation bought back, over the last
        rollup, as a ``capacity.recovered`` record. Never raises."""
        record: dict = {
            "cause": cause, "plan_id": plan_id, "moves": int(moves),
            "fragmentation_before": round(float(fragmentation_before), 4),
            "fragmentation_after": round(float(fragmentation_after), 4),
        }
        try:
            hosts = self._derive_hosts(self.fleet.payload(max_age_s=None).get("nodes", {}))
            fleet = self._fleet_rollup(hosts)
            record["fleet_free"] = fleet["free"]
            record["fleet_largest_block"] = fleet["largest_block"]
        except Exception as exc:  # noqa: BLE001 — the moves landed already
            logger.exception("capacity recovery stamp failed: %s", exc)
            record["error"] = f"{type(exc).__name__}: {exc}"
        outcome = (f"recovered: fleet fragmentation {record['fragmentation_before']} -> "
                   f"{record['fragmentation_after']} after {moves} move(s) (cause: {cause})")
        AUDIT.record("capacity.recovered", actor="capacity-plane", outcome=outcome, **record)
        return record


# --- the process's plane, for the callers without a reference to it ---

_PLANE: CapacityPlane | None = None


def register_plane(plane: CapacityPlane | None) -> None:
    """``MasterApp`` registers its plane here (the newest wins), so that
    the reconciler's and the allocator's calls below reach it."""
    global _PLANE
    _PLANE = plane


def unregister_plane(plane: CapacityPlane) -> None:
    """A closing ``MasterApp``'s plane stops being the process's, unless a
    newer one took its place."""
    global _PLANE
    if _PLANE is plane:
        _PLANE = None


def record_rejection(node: str, namespace: str, pod: str, chips: int) -> None:
    """The registered plane's rejection stamp; nothing without a plane (a
    bare worker process). Never raises."""
    plane = _PLANE
    if plane is not None:
        plane.record_rejection(node, namespace, pod, chips)


def blocked_hosts() -> frozenset[str]:
    """The registered plane's blocked hosts; empty without a plane. Never
    raises."""
    plane = _PLANE
    if plane is None:
        return frozenset()
    return plane.blocked_hosts(max_age_s=None)
