"""A diurnal fleet of H100 hosts, simulated, for the autoscaler.

The counterpart of ``gpumounter_tpu/testing/diurnal.py``, in its NVSwitch
form. A deterministic world that the REAL ``AutoscaleController`` (and the
``ThroughputModel`` in it) runs against; nothing here makes a decision. The
sim plays the parts of the cluster the controller reads through its seams:

  fleet      ``DiurnalSim.payload(max_age_s=...)``: the node map the fleet
             collector makes, each node's ``capacity`` section (free, held,
             warm, fenced over a host of 8 GPUs) and the tenants' snapshots
             (cumulative steps and tokens, as ``torchside/telemetry.py``
             publishes them). The controller is driven with this object and
             the sim's clock.

  tenants    each tenant's server follows rate(b) = r_max * b / (b + b_half);
             the sim publishes batches derived from the true load (on the
             curve, with jitter), and the model must find the curve again
             from the cumulative counters.

  demand     a tenant's arrivals: a base plus a phase-shifted positive half
             sine, with multiplicative noise, drawn once a seed, so that every
             leg serves the same requests.

  elastic    a store and enqueue fake records every intent the controller
             writes; ``reconcile()`` then places and releases GPUs as the
             reconciler and the allocator would: a grow takes warm GPUs
             first, then the free GPUs of one healthy host (the host with the
             fewest that suffice, its lowest-indexed), then scatters; a
             shrink's GPUs go to the warm pool until their TTL.

  chaos      ``kill_nodes`` drops hosts and their GPUs, and
             ``quarantine_hosts`` feeds the health seam's excluded_hosts.

The NVSwitch form: every pair of GPUs of a host is joined, so a host's free
GPUs are one block (``_components``), and the reference's ICI geometry goes.
What follows from it (ROADMAP §3, "The NVSwitch diurnal sim"): the ballast's
free pair {0, 3} is a block of 2; the defragmenter fake's plan has no moves,
so the reference's ``compact`` (its run) has no caller and is left out; and
so is ``fragment_wave``, whose rule "claim until no free block of 2 or more
survives" would exhaust every host but one GPU on NVSwitch, a loss of
capacity and not a fragmentation.

Everything is seeded and free of the wall clock: the same seed gives the
same run.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field

from gpumounter_tpu_torch.elastic.intents import Intent

#: GPUs a simulated host: an H100 host's 8, on NVSwitch
GPUS_PER_NODE = 8
#: steps each tenant reports a tick (the counters' granularity)
STEPS_PER_TICK = 24


def _components(free: set[int]) -> list[set[int]]:
    """The blocks of a host's free GPUs: one, since NVSwitch joins every
    pair (the reference walks the 2x4 board's ICI links)."""
    return [set(free)] if free else []


@dataclass
class TenantProfile:
    """One tenant's demand curve and its server's curve."""

    name: str          # namespace/pod
    base_rps: float    # the floor demand, requests/s
    amp_rps: float     # the diurnal amplitude (a positive half sine)
    phase: float       # the fraction of a day the peak is shifted by
    min_chips: int = 2
    r_max: float = 5000.0   # the true curve's plateau, tokens/s
    b_half: float = 12.0    # tokens a step at half saturation

    def rate(self, tick: int, day_ticks: int) -> float:
        wave = math.sin(2.0 * math.pi * (tick / float(day_ticks) + self.phase))
        return self.base_rps + self.amp_rps * max(0.0, wave)

    def peak_rps(self, day_ticks: int) -> float:
        return max(self.rate(t, day_ticks) for t in range(day_ticks))

    def mean_rps(self, day_ticks: int) -> float:
        return sum(self.rate(t, day_ticks) for t in range(day_ticks)) / float(day_ticks)


def build_arrivals(profiles: list[TenantProfile], ticks: int, day_ticks: int, tick_s: float,
                   seed: int) -> dict[str, list[float]]:
    """The requests arriving a tick a tenant, drawn once a seed, so that
    every leg serves the same sequence."""
    rng = random.Random(seed)
    out: dict[str, list[float]] = {}
    for profile in profiles:
        series = []
        for tick in range(ticks):
            jitter = max(0.0, rng.gauss(1.0, 0.05))
            series.append(profile.rate(tick, day_ticks) * tick_s * jitter)
        out[profile.name] = series
    return out


@dataclass
class _Tenant:
    profile: TenantProfile
    chips: set = field(default_factory=set)    # {(node, gpu index)}
    queue: float = 0.0
    steps: float = 0.0
    tokens: float = 0.0
    requests: float = 0.0
    served_work: float = 0.0
    cap_work: float = 0.0
    breach_ticks: list = field(default_factory=list)
    snapshot: dict | None = None


class _Node:
    __slots__ = ("held", "warm", "killed")

    def __init__(self):
        self.held: dict[int, str] = {}       # gpu -> owner
        self.warm: dict[int, int] = {}       # gpu -> expiry tick
        self.killed = False

    def free_set(self) -> set[int]:
        return set(range(GPUS_PER_NODE)) - set(self.held) - set(self.warm)


class _Store:
    """The intent store's seam: the controller's durable output."""

    def __init__(self):
        self.intents: dict[tuple[str, str], Intent] = {}
        self.puts: list[tuple[str, str, Intent]] = []

    def put(self, namespace: str, pod_name: str, intent: Intent) -> Intent:
        self.intents[(namespace, pod_name)] = intent
        self.puts.append((namespace, pod_name, intent))
        return intent

    def list(self):
        return [(ns, pod, i) for (ns, pod), i in sorted(self.intents.items())]


class _Elastic:
    def __init__(self, store: _Store):
        self.store = store
        self.enqueued: list[tuple[str, str]] = []

    def enqueue(self, namespace: str, pod_name: str) -> None:
        self.enqueued.append((namespace, pod_name))


class _Api:
    """ApiHealth's seam; ``down`` is flipped for an outage."""

    def __init__(self):
        self.down = False

    def ok(self) -> bool:
        return not self.down

    def state(self) -> str:
        return "down" if self.down else "healthy"


class _Slo:
    """The SLO engine's seam; ``burning`` is flipped for a burn."""

    def __init__(self):
        self.burning = False

    def evaluate(self) -> dict:
        return {"burn_threshold": 2.0,
                "objectives": [{"name": "tenant-disruption-free-minutes", "breached": False,
                                "burn_fast": 3.5 if self.burning else 0.1}]}


class _Health:
    def __init__(self):
        self.quarantined: set[str] = set()

    def excluded_hosts(self) -> frozenset:
        return frozenset(self.quarantined)


class _Defrag:
    """The DefragController's seam: plan() names the hosts whose free GPUs
    are more than one block, which on NVSwitch is none, so the controller
    never calls run()."""

    def __init__(self):
        self.requests = 0

    def plan(self) -> dict:
        self.requests += 1
        return {"id": f"dfp-sim-{self.requests}", "moves": []}


class DiurnalSim:
    """The simulated fleet and its tenants (see the module's docstring)."""

    def __init__(self, profiles: list[TenantProfile], n_nodes: int, seed: int,
                 tick_s: float = 60.0, per_chip_rps: float = 1.0, day_ticks: int = 1440,
                 warm_ttl_ticks: int = 240, slo_wait_s: float = 180.0, util_cap: float = 0.97):
        self.rng = random.Random(seed + 1)
        self.tick_s = tick_s
        self.per_chip_rps = per_chip_rps
        self.day_ticks = day_ticks
        self.warm_ttl_ticks = warm_ttl_ticks
        self.slo_wait_s = slo_wait_s
        self.util_cap = util_cap
        self.now = 1_000_000.0
        self.tick_index = 0
        self.nodes: dict[str, _Node] = {f"sim-{i:04d}": _Node() for i in range(n_nodes)}
        self.tenants: dict[str, _Tenant] = {p.name: _Tenant(profile=p) for p in profiles}
        # the seams the controller is wired to
        self.store = _Store()
        self.elastic = _Elastic(self.store)
        self.api = _Api()
        self.slo = _Slo()
        self.health = _Health()
        self.defrag = _Defrag()
        # the leg's counters
        self.warm_attaches = 0
        self.scatter_allocs = 0
        self.unplaced = 0
        self.quarantine_placements = 0
        self.ballast_surge = 0
        # the initial provision's intents
        for p in profiles:
            desired = max(p.min_chips, int(math.ceil(p.rate(0, day_ticks) / per_chip_rps)))
            ns, pod = p.name.split("/", 1)
            self.store.put(ns, pod, Intent(desired_chips=desired, min_chips=p.min_chips))

    def controller_kwargs(self) -> dict:
        """Everything AutoscaleController takes, wired to this sim."""
        return {"elastic": self.elastic, "capacity": None, "fleet": self, "slo": self.slo,
                "apihealth": self.api, "health": self.health, "defrag": self.defrag,
                "clock": lambda: self.now}

    # --- the fleet's seam ---

    def payload(self, max_age_s: float | None = None) -> dict:  # noqa: ARG002
        nodes: dict[str, dict] = {}
        alive = [n for n, node in sorted(self.nodes.items()) if not node.killed]
        for name in alive:
            node = self.nodes[name]
            nodes[name] = {"capacity": {"total": GPUS_PER_NODE, "free": sorted(node.free_set()),
                                        "held": dict(node.held), "warm": sorted(node.warm),
                                        "fenced": []}}
        # the tenants' telemetry rides the first live host's entry:
        # merge_tenants dedups by name, so one section is as good as one a
        # home node
        if alive:
            nodes[alive[0]]["tenants"] = {name: dict(t.snapshot)
                                          for name, t in self.tenants.items()
                                          if t.snapshot is not None}
        return {"at": self.now, "nodes": nodes}

    # --- the ballast (the fleet's other workloads) ---

    def seed_ballast(self, open_nodes: int) -> None:
        """Every host past the first ``open_nodes`` is held by other
        workloads but for GPUs 0 and 3, which on NVSwitch are a block of 2
        (the reference's ICI board makes them two singletons)."""
        for i, (name, node) in enumerate(sorted(self.nodes.items())):
            if i < open_nodes:
                continue
            for gpu in range(GPUS_PER_NODE):
                if gpu not in (0, 3):
                    node.held[gpu] = f"ballast/b{i:04d}"

    # --- chaos ---

    def kill_nodes(self, count: int) -> list[str]:
        """Kill hosts that hold tenant GPUs: the GPUs are gone, and the host
        leaves the fleet's payload."""
        tenant_hosts = sorted({n for t in self.tenants.values() for (n, _) in t.chips})
        victims = self.rng.sample(tenant_hosts, min(count, len(tenant_hosts)))
        for name in victims:
            self.nodes[name].killed = True
            self.nodes[name].warm.clear()
            for tenant in self.tenants.values():
                tenant.chips = {(n, c) for (n, c) in tenant.chips if n != name}
        return victims

    def quarantine_hosts(self, count: int) -> list[str]:
        alive = [n for n, node in sorted(self.nodes.items()) if not node.killed]
        picked = self.rng.sample(alive, min(count, len(alive)))
        self.health.quarantined.update(picked)
        return picked

    def release_quarantine(self) -> None:
        self.health.quarantined.clear()

    # --- the reconciler and the allocator ---

    def reconcile(self) -> None:
        """Drive every tenant's placed GPUs toward its intent."""
        for (ns, pod), intent in sorted(self.store.intents.items()):
            tenant = self.tenants.get(f"{ns}/{pod}")
            if tenant is None:
                continue
            current = len(tenant.chips)
            if intent.desired_chips > current:
                self._allocate(tenant, intent.desired_chips - current)
            elif intent.desired_chips < current:
                self._release(tenant, current - intent.desired_chips)

    def _eligible(self) -> list[tuple[str, _Node]]:
        return [(name, node) for name, node in sorted(self.nodes.items())
                if not node.killed and name not in self.health.quarantined]

    def _allocate(self, tenant: _Tenant, need: int) -> None:
        owner = tenant.profile.name
        # 1. the warm pool first: drained GPUs attach fastest
        for name, node in self._eligible():
            while need and node.warm:
                gpu = min(node.warm)
                del node.warm[gpu]
                node.held[gpu] = owner
                tenant.chips.add((name, gpu))
                self.warm_attaches += 1
                need -= 1
        if not need:
            return
        # 2. one host's free GPUs: the host with the fewest that suffice
        best: tuple[str, _Node, set] | None = None
        for name, node in self._eligible():
            for comp in _components(node.free_set()):
                if len(comp) >= need and (best is None or len(comp) < len(best[2])):
                    best = (name, node, comp)
        if best is not None:
            name, node, comp = best
            for gpu in sorted(comp)[:need]:
                node.held[gpu] = owner
                tenant.chips.add((name, gpu))
            return
        # 3. scatter (counted; the feasibility gate should make it rare)
        for name, node in self._eligible():
            for gpu in sorted(node.free_set()):
                if not need:
                    return
                node.held[gpu] = owner
                tenant.chips.add((name, gpu))
                self.scatter_allocs += 1
                need -= 1
        self.unplaced += need

    def _release(self, tenant: _Tenant, count: int) -> None:
        """The graceful drain: released GPUs go to the warm pool until their
        TTL."""
        victims = sorted(tenant.chips)[-count:]
        expiry = self.tick_index + self.warm_ttl_ticks
        for (name, gpu) in victims:
            tenant.chips.discard((name, gpu))
            node = self.nodes[name]
            node.held.pop(gpu, None)
            if not node.killed:
                node.warm[gpu] = expiry

    # --- time ---

    def tick(self, arrivals: dict[str, list[float]]) -> None:
        """One tick: expire warm GPUs, serve the demand, publish telemetry."""
        i = self.tick_index
        self.now += self.tick_s
        for node in self.nodes.values():
            if node.killed:
                continue
            for gpu in [c for c, exp in node.warm.items() if exp <= i]:
                del node.warm[gpu]
        for name, tenant in self.tenants.items():
            arr = arrivals[name][i]
            chips = len(tenant.chips)
            cap = chips * self.per_chip_rps * self.tick_s
            demand = arr + tenant.queue
            served = min(cap, demand)
            tenant.queue = demand - served
            tenant.requests += arr
            tenant.served_work += served
            tenant.cap_work += cap
            wait_s = tenant.queue / (chips * self.per_chip_rps) if chips else float("inf")
            if wait_s > self.slo_wait_s:
                tenant.breach_ticks.append(i)
            # the telemetry: a batch and rate on the curve, from the true load
            load = (demand / cap) if cap > 0 else self.util_cap
            u = min(0.95, min(self.util_cap, load))
            batch = tenant.profile.b_half * u / (1.0 - u)
            batch *= 1.0 + self.rng.uniform(-0.08, 0.08)
            rate = tenant.profile.r_max * batch / (batch + tenant.profile.b_half)
            tenant.steps += STEPS_PER_TICK
            tenant.tokens += batch * STEPS_PER_TICK
            tenant.snapshot = {"steps": {"count": tenant.steps},
                               "tokens_total": round(tenant.tokens, 3),
                               "tokens_per_s": round(rate, 3),
                               "queue_depth": round(tenant.queue, 1), "at": self.now}
        self.tick_index += 1

    # --- the leg's summary ---

    def utilization(self) -> float:
        cap = sum(t.cap_work for t in self.tenants.values())
        served = sum(t.served_work for t in self.tenants.values())
        return (served / cap) if cap else 0.0

    def total_requests(self) -> float:
        return sum(t.requests for t in self.tenants.values())

    def breach_ticks(self) -> dict[str, list[int]]:
        return {name: list(t.breach_ticks) for name, t in sorted(self.tenants.items())
                if t.breach_ticks}


def run_static_leg(profiles: list[TenantProfile], arrivals: dict[str, list[float]],
                   chips_by_tenant: dict[str, int], ticks: int, tick_s: float,
                   per_chip_rps: float, slo_wait_s: float) -> dict:
    """The control leg: the same arrivals served by a fixed allocation (no
    controller, no chaos), summarized as the autoscaled leg is."""
    served_total = cap_total = 0.0
    breach_ticks = 0
    queues = {p.name: 0.0 for p in profiles}
    for i in range(ticks):
        for p in profiles:
            chips = chips_by_tenant[p.name]
            cap = chips * per_chip_rps * tick_s
            demand = arrivals[p.name][i] + queues[p.name]
            served = min(cap, demand)
            queues[p.name] = demand - served
            served_total += served
            cap_total += cap
            wait_s = queues[p.name] / (chips * per_chip_rps) if chips else float("inf")
            if wait_s > slo_wait_s:
                breach_ticks += 1
    return {"chips_total": sum(chips_by_tenant.values()),
            "utilization": round(served_total / cap_total, 4) if cap_total else 0.0,
            "breach_ticks_total": breach_ticks}
