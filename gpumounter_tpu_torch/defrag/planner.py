"""The defragmentation planner: a capacity snapshot in, a move plan out.

The counterpart of ``gpumounter_tpu/defrag/planner.py``, in its NVSwitch
form. Pure logic, no I/O: the controller feeds it the fleet collector's node
entries (each with the worker's ``capacity`` section, the inventory
``obs/capacity.py`` derives its views from) and gets back a JSON-able plan. A
stale snapshot is refused here, before anything else, so nothing can act on
it (the negative control).

The unit of work is a group: the moves that turn one blocked host into one
that holds a free block of the target size. Groups are the plan's barrier
points: the controller samples the fleet's fragmentation index after each,
and chaos invariant 18 asserts the samples never rise.

The reference walks the 2-wide ICI grid at three seams; the port takes the
NVSwitch block there, since every pair of an H100 host's GPUs is joined
(``obs.capacity.largest_block``, a host's count of free GPUs):

  * a host is blocked when ``free < target <= free + warm``, the capacity
    plane's ``admissible-after-defrag`` rule: on NVSwitch only warm holders
    block a host;
  * an unblocking subset is the fewest tenants whose GPUs, added to the free
    ones, reach the target (the reference's order of minimality and
    MAX_EVICTIONS_PER_HOST);
  * a move lands on the host with the fewest free GPUs that are enough, on its
    lowest-indexed free GPUs, the ones the fake scheduler's remount takes
    (the reference's ``placement.best_block`` is left out with
    ``allocator/placement.py``).

``fleet_fragmentation_index`` keeps the reference's formula, so on the port
it is always 0, and the ``would-raise-fragmentation`` refusal is kept but
cannot fire. Constraints (config.py ``defrag_*``): at most ``max_moves``
migrations a plan, no tenant moved more than ``tenant_move_budget`` times,
and each move priced by the caller's cost model (the migration journals'
phase times; the fleet median for a tenant that never moved). Groups are
scheduled cheapest first, so a budget that bites bought the most capacity it
could.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from gpumounter_tpu_torch.obs.capacity import largest_block
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("defrag.planner")

#: the most tenants evicted to unblock one host: subsets are searched
#: exhaustively up to this size (a host has at most 8 GPUs); a host that
#: needs more is reported, not swept
MAX_EVICTIONS_PER_HOST = 3


class PlanError(Exception):
    """The planner's refusal. ``cause`` is machine-readable and bounded:
    "stale-snapshot" is the negative control's (a planner fed an outdated
    view refuses, it does not thrash)."""

    def __init__(self, message: str, cause: str = "invalid", status: int = 409):
        super().__init__(message)
        self.cause = cause
        self.status = status


@dataclass
class HostView:
    """One host's planning view, parsed from its inventory section."""

    node: str
    free: set[int] = field(default_factory=set)
    warm: set[int] = field(default_factory=set)
    fenced: set[int] = field(default_factory=set)
    held: dict[int, str] = field(default_factory=dict)  # index -> ns/pod
    stale: bool = False
    known: bool = True

    def tenants(self) -> dict[str, list[int]]:
        out: dict[str, list[int]] = {}
        for index, tenant in sorted(self.held.items()):
            out.setdefault(tenant, []).append(index)
        return out


def parse_hosts(nodes: dict[str, dict]) -> dict[str, HostView]:
    """The collector's node entries as planning views. A stale entry, or
    one without an inventory section, parses as unknown: the planner
    neither evicts from nor places onto a host it cannot see."""
    hosts: dict[str, HostView] = {}
    for node, entry in (nodes or {}).items():
        if not isinstance(entry, dict):
            continue
        raw = entry.get("capacity")
        if bool(entry.get("stale")) or not isinstance(raw, dict):
            hosts[node] = HostView(node=node, stale=bool(entry.get("stale")), known=False)
            continue
        held = {int(k): str(v) for k, v in (raw.get("held") or {}).items()}
        hosts[node] = HostView(
            node=node,
            free={int(i) for i in raw.get("free") or []},
            warm={int(i) for i in raw.get("warm") or []},
            fenced={int(i) for i in raw.get("fenced") or []},
            held=held,
            known=bool(raw.get("ownership_known", True)))
    return hosts


def fleet_fragmentation_index(hosts: dict[str, HostView]) -> float:
    """The capacity plane's weighted fleet index, 1 - achievable / free,
    over planning views: the same formula, so a predicted index and the
    /capacity payload's compare. With the NVSwitch block it is 0."""
    free = 0
    achievable = 0
    for view in hosts.values():
        if not view.known and not view.free:
            continue
        free += len(view.free)
        achievable += largest_block(sorted(view.free))
    return round(1.0 - achievable / free, 4) if free else 0.0


def _blocked_hosts(hosts: dict[str, HostView], target_block: int) -> list[HostView]:
    """The hosts the feasibility table calls admissible-after-defrag at
    this block size: the free and warm GPUs reach it, the free ones alone
    do not."""
    out = []
    for view in hosts.values():
        if view.stale or not view.known:
            continue
        if len(view.free) + len(view.warm) < target_block:
            continue
        if largest_block(sorted(view.free)) >= target_block:
            continue
        out.append(view)
    return sorted(out, key=lambda v: v.node)


def _unblock_subset(view: HostView, target_block: int,
                    cost_fn) -> tuple[list[str], float] | None:
    """The cheapest set of tenants whose eviction leaves a free block of
    `target_block` GPUs. Minimality: fewest moves, then the lowest summed
    cost, then the fewest GPUs evicted. None when no set within
    MAX_EVICTIONS_PER_HOST does it."""
    tenants = view.tenants()
    names = sorted(tenants)
    best: tuple[tuple[int, float, int], list[str]] | None = None
    for size in range(1, min(MAX_EVICTIONS_PER_HOST, len(names)) + 1):
        for combo in itertools.combinations(names, size):
            evicted = set().union(*(tenants[t] for t in combo))
            if largest_block(sorted(view.free | evicted)) < target_block:
                continue
            cost = sum(cost_fn(t, len(tenants[t])) for t in combo)
            rank = (size, cost, len(evicted))
            if best is None or rank < best[0]:
                best = (rank, list(combo))
        if best is not None:
            break  # a smaller set always beats a larger one
    if best is None:
        return None
    return best[1], best[0][1]


def _place(sim: dict[str, HostView], source: str, n_gpus: int,
           avoid: set[str]) -> tuple[str, list[int]] | None:
    """A destination host and GPUs for an evicted tenant: best fit over the
    simulated free sets (the fewest free GPUs that are enough, so a roomy
    host is kept for a large tenant), never a host in `avoid`. The GPUs are
    the host's lowest-indexed free ones."""
    candidates: list[tuple[int, str]] = []
    for node, view in sim.items():
        if node == source or node in avoid or view.stale or not view.known:
            continue
        block = largest_block(sorted(view.free))
        if block >= n_gpus:
            candidates.append((block, node))
    if not candidates:
        return None
    # the node's name breaks a tie, so a re-plan over the same snapshot
    # converges on the same plan
    candidates.sort()
    node = candidates[0][1]
    return node, sorted(sim[node].free)[:n_gpus]


def plan_moves(nodes: dict[str, dict], *,
               target_block: int,
               max_moves: int,
               tenant_move_budget: int = 1,
               snapshot_at: float | None = None,
               max_snapshot_age_s: float | None = None,
               now: float | None = None,
               non_destinations: frozenset[str] | set[str] = frozenset(),
               cost_fn=None) -> dict:
    """A move plan from a capacity snapshot.

    `nodes` is the fleet collector's node map. With `snapshot_at`,
    `max_snapshot_age_s` and `now` the snapshot's age is checked first, and
    a stale one (or one of unknown age) raises PlanError("stale-snapshot").
    `non_destinations` (the health plane's quarantined hosts) are hosts no
    evicted tenant may land on. Returns a JSON-able plan, whose `moves` is
    empty when nothing is blocked."""
    if max_snapshot_age_s is not None and now is not None:
        if snapshot_at is None:
            raise PlanError("capacity snapshot has no collection timestamp; "
                            "refusing to plan against a view of unknown age",
                            cause="stale-snapshot")
        age = now - float(snapshot_at)
        if age > max_snapshot_age_s:
            raise PlanError(f"capacity snapshot is {age:.1f}s old (bound "
                            f"{max_snapshot_age_s:.0f}s); refusing to plan moves "
                            f"against a stale view — re-collect and re-plan",
                            cause="stale-snapshot")
    if cost_fn is None:
        def cost_fn(_tenant: str, n_gpus: int) -> float:
            return float(n_gpus)  # a flat estimate a GPU
    hosts = parse_hosts(nodes)
    frag_before = fleet_fragmentation_index(hosts)
    blocked = _blocked_hosts(hosts, target_block)

    # one candidate group a blocked host, cheapest first
    candidates: list[dict] = []
    skipped: list[dict] = []
    for view in blocked:
        found = _unblock_subset(view, target_block, cost_fn)
        if found is None:
            skipped.append({"node": view.node, "reason": "no-eviction-subset"})
            continue
        tenants, cost = found
        candidates.append({"node": view.node, "tenants": tenants,
                           "est_cost_s": round(cost, 3)})
    candidates.sort(key=lambda g: (g["est_cost_s"], g["node"]))

    sim = parse_hosts(nodes)  # a copy of its own to simulate on
    moves: list[dict] = []
    groups: list[dict] = []
    tenant_moves: dict[str, int] = {}
    frag_at_barrier = frag_before
    # no evicted tenant lands on any blocked host, scheduled or not: taking
    # its free GPUs could undo the unblocking computed for it above
    blocked_names = {v.node for v in blocked}
    for group in candidates:
        node = group["node"]
        view = sim[node]
        tenants_here = view.tenants()
        if len(moves) + len(group["tenants"]) > max_moves:
            skipped.append({"node": node, "reason": "move-budget"})
            continue
        if any(tenant_moves.get(t, 0) + 1 > tenant_move_budget for t in group["tenants"]):
            skipped.append({"node": node, "reason": "tenant-budget"})
            continue
        # every eviction placed, or none of the group's
        unblocking = blocked_names | {node} | set(non_destinations)
        staged: list[dict] = []
        placed_ok = True
        snapshot = {n: (set(v.free), dict(v.held)) for n, v in sim.items()}
        for tenant in group["tenants"]:
            gpus = tenants_here.get(tenant) or []
            placed = _place(sim, node, len(gpus), avoid=unblocking)
            if placed is None:
                placed_ok = False
                skipped.append({"node": node, "tenant": tenant, "reason": "no-destination"})
                break
            dest, dest_gpus = placed
            namespace, _, pod = tenant.partition("/")
            staged.append({
                "namespace": namespace, "pod": pod,
                "source_node": node, "dest_node": dest,
                "chips": len(gpus), "source_indices": sorted(gpus),
                "dest_indices": sorted(dest_gpus),
                "est_cost_s": round(cost_fn(tenant, len(gpus)), 3),
                "group": node,
            })
            view.free.update(gpus)
            for index in gpus:
                view.held.pop(index, None)
            sim[dest].free.difference_update(dest_gpus)
            for index in dest_gpus:
                sim[dest].held[index] = tenant
        frag_here = fleet_fragmentation_index(sim)
        if not placed_ok or frag_here > frag_at_barrier:
            # a group that cannot place whole, or would raise the fleet's
            # index, is dropped, never scheduled in part (on NVSwitch the
            # index is 0 throughout, so only the first can happen)
            for n, (free, held) in snapshot.items():
                sim[n].free = free
                sim[n].held = held
            if placed_ok:
                skipped.append({"node": node, "reason": "would-raise-fragmentation"})
            continue
        for staged_move in staged:
            tenant = f"{staged_move['namespace']}/{staged_move['pod']}"
            tenant_moves[tenant] = tenant_moves.get(tenant, 0) + 1
        moves.extend(staged)
        groups.append({"node": node, "moves": len(staged),
                       "est_cost_s": group["est_cost_s"],
                       "predicted_fragmentation_index": frag_here})
        frag_at_barrier = frag_here

    return {
        "target_block": int(target_block),
        "snapshot_at": snapshot_at,
        "moves": moves,
        "groups": groups,
        "skipped": skipped,
        "blocked_hosts": [v.node for v in blocked],
        "fragmentation_before": frag_before,
        "fragmentation_after": frag_at_barrier,
        "est_disruption_s": {t: round(sum(
            m["est_cost_s"] for m in moves
            if f"{m['namespace']}/{m['pod']}" == t), 3)
            for t in tenant_moves},
        "tenant_moves": tenant_moves,
    }
