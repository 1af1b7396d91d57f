"""The fleet telemetry plane: the master's one view over every worker.

The counterpart of ``gpumounter_tpu/obs/fleet.py``. A ``FleetCollector``
pulls each worker's telemetry snapshot (the mount-latency histogram with its
trace-id exemplars, the mount, unmount, warm-pool, rollback and program-swap
counters, the per-tenant device-access counts, the tenants' own snapshots
and the newest spans) with the CollectTelemetry RPC, falls back to
scraping the worker's /metrics exposition for a worker without it
(UNIMPLEMENTED, or a payload that does not parse), and rolls
everything into a node-keyed model that /fleet serves and the SLO engine
(``obs/slo.py``) reads.

No double counting by construction: the per-node state is a dict keyed by
node name whose entries are replaced whole every pass, and every number a
worker reports is an absolute counter or histogram, never a delta; so a
restarted collector, or one more pass, cannot inflate the rollup (chaos
invariant 8). An active sharded replica (``master/shard.py``) collects only
the nodes it owns, on the fan-out core (``utils/fanout.py``) with its
per-shard budgets.

``capacity``, the capacity plane (``obs/capacity.py``), observes every pass
first, so that the feasibility counters it moves ride this pass's rollup;
``health``, the gray-failure plane (``health/plane.py``), observes it next,
and its quarantined nodes (``excluded_hosts()``) are the ones whose pull sets
the request's ``quarantined``: the worker then drains its warm pool. The
reference's ``autoscale_model`` stays None until its package is ported. The
worker's snapshot carries its GPUs in a ``capacity`` section; the scrape
fallback's is None, as the reference's. Standard library only: the worker
imports the snapshot half on its mount path, and the RPC comes in through
the client factory.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.request

from gpumounter_tpu_torch.cgroup.ebpf import DEVICE_TELEMETRY
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.obs import assembly, trace
from gpumounter_tpu_torch.obs.tenants import TENANTS
from gpumounter_tpu_torch.utils.auth import resolve_read_token, resolve_token
from gpumounter_tpu_torch.utils.fanout import get_core
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    estimate_quantile,
)

logger = get_logger("obs.fleet")

TELEMETRY_SCHEMA = "tpumounter-telemetry/1"

FLEET_COLLECTIONS = REGISTRY.counter(
    "tpumounter_fleet_collections_total",
    "Fleet telemetry collection passes by node outcome (rpc / scrape / "
    "error)")
FLEET_NODES = REGISTRY.gauge(
    "tpumounter_fleet_nodes",
    "Nodes in the last fleet rollup")
FLEET_COLLECT_DURATION = REGISTRY.histogram(
    "tpumounter_fleet_collect_duration_seconds",
    "Wall time of one whole-fleet collection pass")

#: (exposition name, the snapshot's counter key): the counters a worker's
#: snapshot carries and the scrape recovers, read by name through
#: REGISTRY.find so that the master imports none of the worker's modules
_COUNTER_NAMES = (
    ("tpumounter_mount_total", "mount_total"),
    ("tpumounter_unmount_total", "unmount_total"),
    ("tpumounter_warm_pool_hits_total", "warm_pool_hits"),
    ("tpumounter_warm_pool_misses_total", "warm_pool_misses"),
    ("tpumounter_mount_rollback_failures_total", "rollback_failures"),
    ("tpumounter_ebpf_program_swaps_total", "ebpf_program_swaps"),
)

#: the master's counters in the rollup: the heals and the migrations, the
#: breakers' trips, and the capacity plane's feasibility evaluations (the
#: slice-feasibility SLO's good and bad events); a series not registered in
#: the process reads 0
_MASTER_COUNTER_NAMES = (
    ("tpumounter_chips_healed_total", "heals"),
    ("tpumounter_chips_heal_failures_total", "heal_failures"),
    ("tpumounter_migrations_total", "migrations"),
    ("tpumounter_worker_breaker_trips_total", "breaker_trips"),
    ("tpumounter_capacity_size_feasible_total", "slice_feasible"),
    ("tpumounter_capacity_size_infeasible_total", "slice_infeasible"),
)


def _labeled_totals(metric) -> dict[str, float]:
    """A counter folded to {its first label's value or "": total}."""
    if metric is None or not isinstance(metric, (Counter, Gauge)):
        return {}
    out: dict[str, float] = {}
    for key, value in metric.snapshot().items():
        label = key[0][1] if key else ""
        out[label] = out.get(label, 0.0) + value
    return out


def worker_telemetry_snapshot(cfg=None, registry=None) -> dict:
    """This process's snapshot: the CollectTelemetry payload and the ops
    port's /telemetry body. Every value is absolute (since the process
    started), so a consumer may read it again without double counting. The
    newest span_export_max spans of the ring ride along (0 sends none);
    the master dedupes them by span id."""
    reg = registry or REGISTRY
    latency = reg.find("tpumounter_mount_latency_seconds")
    mount_hist: dict = {"buckets": [], "count": 0, "sum": 0.0, "exemplars": []}
    if isinstance(latency, Histogram):
        counts = [0] * (len(latency.buckets) + 1)
        total = 0.0
        exemplars = []
        for entry in latency.snapshot().values():
            for i, c in enumerate(entry["counts"]):
                counts[i] += c
            total += entry["sum"]
            for idx, (tid, value, ts) in entry["exemplars"].items():
                bound = latency.buckets[idx] if idx < len(latency.buckets) else "+Inf"
                exemplars.append({"le": bound, "trace_id": tid, "value": value, "at": ts})
        mount_hist = {"buckets": [[b, counts[i]] for i, b in enumerate(latency.buckets)],
                      "count": counts[-1], "sum": round(total, 6), "exemplars": exemplars}
    counters = {key: _labeled_totals(reg.find(name)) for name, key in _COUNTER_NAMES}
    device_access: dict[str, dict[str, float]] = {}
    for (tenant, kind), value in DEVICE_TELEMETRY.counts().items():
        device_access.setdefault(tenant, {})[kind] = value
    span_cap = int(cfg.span_export_max) if cfg is not None else 512
    snap = {
        "schema": TELEMETRY_SCHEMA,
        "at": round(time.time(), 3),
        "mount_latency": mount_hist,
        "counters": counters,
        "device_access": device_access,
        "tenants": TENANTS.export(),
        "spans": trace.TRACER.ring.tail(span_cap),
    }
    if cfg is not None and cfg.node_name:
        snap["node"] = cfg.node_name
    return snap


def parse_telemetry(raw: object) -> dict | None:
    """A payload as a snapshot, or None for anything a peer could put on the
    wire that is not one (empty, of the wrong type, not JSON, not an object,
    another schema); never raises. The collector then scrapes."""
    if not raw or not isinstance(raw, str):
        return None
    try:
        doc = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(doc, dict) or doc.get("schema") != TELEMETRY_SCHEMA:
        return None
    return doc


# --- the scrape fallback ---

_SERIES_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^{}]*)\})?\s+(?P<value>[-+0-9.eE]+|[+-]?Inf|NaN)")
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def parse_prometheus_text(text: str) -> dict[str, list[tuple[dict, float]]]:
    """A Prometheus text exposition as {metric name: [(labels, value)]}; a
    line that does not parse is skipped (a worker's exposition is not ours
    to trust)."""
    out: dict[str, list[tuple[dict, float]]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        match = _SERIES_RE.match(line)
        if match is None:
            continue
        labels = dict(_LABEL_RE.findall(match.group("labels") or ""))
        try:
            value = float(match.group("value").replace("Inf", "inf"))
        except ValueError:
            continue
        out.setdefault(match.group("name"), []).append((labels, value))
    return out


def snapshot_from_prometheus(text: str) -> dict:
    """The snapshot's shape from a scraped /metrics exposition: the degraded
    path for a worker without the RPC, with no exemplars (the classic text
    format cannot carry them), no tenants, no spans, and capacity None."""
    series = parse_prometheus_text(text)
    buckets: dict[float, float] = {}
    inf_count = 0.0
    for labels, value in series.get("tpumounter_mount_latency_seconds_bucket", []):
        le = labels.get("le", "")
        if le == "+Inf":
            inf_count += value
            continue
        try:
            bound = float(le)
        except ValueError:
            continue
        buckets[bound] = buckets.get(bound, 0.0) + value
    total = sum(v for _, v in series.get("tpumounter_mount_latency_seconds_sum", []))
    counters: dict[str, dict[str, float]] = {}
    for name, key in _COUNTER_NAMES:
        folded: dict[str, float] = {}
        for labels, value in series.get(name, []):
            label = next(iter(sorted(labels.values())), "")
            folded[label] = folded.get(label, 0.0) + value
        counters[key] = folded
    device_access: dict[str, dict[str, float]] = {}
    for labels, value in series.get("tpumounter_device_access_total", []):
        tenant = labels.get("tenant", "")
        if tenant:
            device_access.setdefault(tenant, {})[labels.get("kind", "")] = value
    return {
        "schema": TELEMETRY_SCHEMA,
        "at": round(time.time(), 3),
        "mount_latency": {"buckets": [[b, buckets[b]] for b in sorted(buckets)],
                          "count": inf_count, "sum": total, "exemplars": []},
        "counters": counters,
        "device_access": device_access,
        "tenants": {},
        "spans": [],
        "capacity": None,
    }


# --- the rollup ---

def _hist_quantile_ms(hist: dict, q: float) -> float:
    pairs = hist.get("buckets") or []
    count = hist.get("count", 0)
    if not pairs or not count:
        return 0.0
    bounds = tuple(b for b, _ in pairs)
    counts = [c for _, c in pairs] + [count]
    return round(estimate_quantile(bounds, counts, q) * 1000.0, 3)


def _counter(snapshot: dict, key: str, label: str | None = None) -> float:
    folded = (snapshot.get("counters") or {}).get(key) or {}
    if label is None:
        return float(sum(folded.values()))
    return float(folded.get(label, 0.0))


def _node_rollup(snapshot: dict) -> dict:
    hist = snapshot.get("mount_latency") or {}
    hits = _counter(snapshot, "warm_pool_hits")
    misses = _counter(snapshot, "warm_pool_misses")
    lookups = hits + misses
    return {
        "mount": {
            "count": hist.get("count", 0),
            "p50_ms": _hist_quantile_ms(hist, 0.50),
            "p95_ms": _hist_quantile_ms(hist, 0.95),
            "success": _counter(snapshot, "mount_total", "success"),
            "error": _counter(snapshot, "mount_total", "error"),
            # the cumulative bucket pairs, so that the fleet view merges
            # the nodes' histograms (one bucket layout everywhere)
            "buckets": list(hist.get("buckets") or []),
        },
        "warm_pool": {"hits": hits, "misses": misses,
                      "hit_rate": round(hits / lookups, 4) if lookups else 0.0},
        "rollback_failures": _counter(snapshot, "rollback_failures"),
        "ebpf_program_swaps": _counter(snapshot, "ebpf_program_swaps"),
        "device_access": snapshot.get("device_access") or {},
        "tenants": snapshot.get("tenants") or {},
        "capacity": snapshot.get("capacity"),
        "exemplars": hist.get("exemplars", []),
    }


def merge_tenants(nodes: dict[str, dict]) -> dict[str, dict]:
    """tenant -> its latest snapshot over every node entry, stamped with the
    node: a tenant seen on two nodes counts once, the freshest `at` wins
    (snapshots are cumulative, so the latest loses nothing)."""
    merged: dict[str, dict] = {}
    for node, entry in sorted(nodes.items()):
        for tenant, snap in (entry.get("tenants") or {}).items():
            if not isinstance(snap, dict):
                continue
            best = merged.get(tenant)
            if best is None or snap.get("at", 0) >= best.get("at", 0):
                merged[tenant] = {**snap, "node": node}
    return merged


def tenants_fleet_rollup(merged: dict[str, dict]) -> dict:
    """The tenants' aggregates over the fleet, the SLO engine's tenant
    inputs: disruption-free and disrupted minutes, steps, windows, and a
    downtime histogram a cause."""
    clean = disrupted = 0.0
    windows_total = seconds_total = steps = 0.0
    open_windows = 0
    downtime: dict[str, dict] = {}
    for snap in merged.values():
        minutes = snap.get("minutes") or {}
        total = float(minutes.get("total", 0))
        bad = float(minutes.get("disrupted", 0))
        clean += max(0.0, total - bad)
        disrupted += bad
        steps += float((snap.get("steps") or {}).get("count", 0))
        dis = snap.get("disruption") or {}
        windows_total += float(dis.get("total_windows", 0))
        seconds_total += float(dis.get("total_seconds", 0.0))
        open_windows += len(dis.get("open") or [])
        for cause, entry in (dis.get("by_cause") or {}).items():
            agg = downtime.setdefault(cause, {"buckets": {}, "count": 0.0, "seconds": 0.0})
            agg["count"] += float(entry.get("windows", 0))
            agg["seconds"] += float(entry.get("seconds", 0.0))
            for bound, cum in entry.get("buckets") or []:
                agg["buckets"][float(bound)] = agg["buckets"].get(float(bound), 0.0) + float(cum)
    return {
        "tenants": len(merged),
        "steps": steps,
        "tenant_clean_minutes": clean,
        "tenant_disrupted_minutes": disrupted,
        "disruption_windows": windows_total,
        "disruption_seconds": round(seconds_total, 4),
        "open_windows": open_windows,
        "downtime": {cause: {"buckets": [[b, agg["buckets"][b]] for b in sorted(agg["buckets"])],
                             "count": agg["count"], "seconds": round(agg["seconds"], 4)}
                     for cause, agg in sorted(downtime.items())},
    }


class FleetCollector:
    """The master's periodic pull of every worker's telemetry.

    `workers` is the ``WorkerRegistry`` (node -> worker IP, and the shared
    breaker, whose state each entry shows); `client_factory(address)` builds
    the telemetry client (the master's has no breaker and a channel of its
    own: a pass never trips the mount path). A node: CollectTelemetry
    first; UNIMPLEMENTED or a payload that does not parse, then a scrape of
    http://<ip>:<METRICS_PORT>/metrics with the read token (else the mutate
    token). A node that answers neither keeps its last entry, marked stale
    with the error: a blip must not blank it out of the fleet view."""

    def __init__(self, workers, client_factory, cfg=None, slo=None, shards=None,
                 span_store=None):
        self.cfg = cfg or Config()
        self.workers = workers
        self.client_factory = client_factory
        self.slo = slo
        #: the spans of every snapshot federate here (``obs/assembly.py``),
        #: so that /trace/<id> joins the master's and the workers' halves
        self.span_store = assembly.REMOTE_SPANS if span_store is None else span_store
        #: a ShardManager: an active replica collects the nodes it owns
        self.shards = shards
        #: the observers of each pass, exception-isolated, in this order:
        #: ``capacity`` (the ``CapacityPlane``) derives /capacity's view and
        #: moves the slice-feasibility counters before the rollup is taken;
        #: ``health`` (the ``HealthPlane``) scores the pass, and its
        #: quarantined nodes ride their pulls; MasterApp sets both.
        #: autoscale_model waits for its package
        self.capacity = None
        self.health = None
        self.autoscale_model = None
        self.interval_s = self.cfg.fleet_scrape_interval_s
        self._lock = OrderedLock("fleet.nodes")
        # one pass at a time: stale readers at the interval's edge must not
        # each start a fan-out. An RLock: collect_once holds it, and
        # refresh_if_stale takes it again around its re-check
        self._collect_mu = threading.RLock()
        #: node -> its entry, replaced every pass
        self._nodes: dict[str, dict] = {}
        self._collected_at = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # --- collection ---

    def _scrape_url(self, ip: str) -> str:
        return f"http://{ip}:{self.cfg.metrics_port}/metrics"

    def _scrape_token(self) -> str | None:
        try:
            return resolve_read_token(self.cfg) or resolve_token(self.cfg)
        except Exception:  # noqa: BLE001 — the scrape goes without a credential
            return None

    def _scrape(self, ip: str) -> dict:
        req = urllib.request.Request(self._scrape_url(ip))
        token = self._scrape_token()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        with urllib.request.urlopen(req, timeout=self.cfg.rpc_telemetry_timeout_s) as resp:
            return snapshot_from_prometheus(resp.read().decode())

    @staticmethod
    def _is_unimplemented(exc: Exception) -> bool:
        """A worker without the telemetry service: the port's typed
        ``RpcCallError`` names the status in `code`; a raw gRPC error has a
        code() method."""
        code = getattr(exc, "code", None)
        if isinstance(code, str):
            return code == "UNIMPLEMENTED"
        if callable(code):
            try:
                return getattr(code(), "name", "") == "UNIMPLEMENTED"
            except Exception:  # noqa: BLE001 — a code() that is not grpc's
                return False
        return False

    def _collect_node(self, node: str, address: str) -> dict:
        ip = address.rsplit(":", 1)[0]
        entry = {"address": address, "collected_at": round(time.time(), 3)}
        snapshot = None
        mode = "rpc"
        quarantined = self.health is not None and node in self.health.excluded_hosts()
        try:
            with self.client_factory(address) as client:
                # the flag only when set: absent is not quarantined on the
                # wire, and a stub without the keyword still answers
                resp = (client.collect_telemetry(quarantined=True) if quarantined
                        else client.collect_telemetry())
            snapshot = parse_telemetry(resp.telemetry)
            if snapshot is None:
                logger.warning("worker %s answered CollectTelemetry with an absent or "
                               "unparseable payload; falling back to scrape", node)
                mode = "scrape"
        except Exception as exc:  # noqa: BLE001 — the RPC's boundary
            if not self._is_unimplemented(exc):
                raise
            mode = "scrape"  # a worker without the telemetry service
        if snapshot is None:
            snapshot = self._scrape(ip)
        entry["mode"] = mode
        # the spans go to the remote store; the node's entry stays without
        # them (/fleet is a rollup, /trace/<id> serves the joined spans)
        self.span_store.ingest(node, snapshot.get("spans") or [])
        entry.update(_node_rollup(snapshot))
        return entry

    def _collect_one(self, node: str, ip: str) -> tuple[str, dict]:
        """One node's collection, on the fan-out core; never raises. Its
        spans are deferred and dropped: steady passes must not rotate the
        operations' traces out of the ring."""
        address = f"{ip}:{self.cfg.worker_port}"
        try:
            with trace.deferred():
                entry = self._collect_node(node, address)
            FLEET_COLLECTIONS.inc(outcome=entry["mode"])
        except Exception as exc:  # noqa: BLE001 — a node must not fail the pass
            FLEET_COLLECTIONS.inc(outcome="error")
            logger.warning("telemetry collection for %s failed: %s", node, exc)
            with self._lock:
                prior = self._nodes.get(node)
            entry = dict(prior) if prior else {"address": address}
            entry["stale"] = True
            entry["error"] = f"{type(exc).__name__}: {exc}"
        breaker = getattr(self.workers, "breaker", None)
        retry_after = breaker.retry_after(address) if breaker is not None else None
        entry["breaker"] = "open" if retry_after is not None else "closed"
        return node, entry

    def collect_once(self) -> dict:
        """One pass over the fleet; returns the fresh rollup. The nodes come
        from the registry's snapshot (its watch-kept cache: no API call); the
        nodes' collections fan out on the core, by owner shard when the
        shards are active. One pass at a time."""
        with self._collect_mu:
            t0 = time.monotonic()
            items = sorted(self.workers.registry_snapshot().items())
            sharded = self.shards is not None and self.shards.active()
            if sharded:
                items = [(node, ip) for node, ip in items if self.shards.owns_node(node)]
            fresh: dict[str, dict] = {}
            if items:
                shard_of = (lambda it: self.shards.owner_shard(it[0])) if sharded else None
                for node, entry in get_core(self.cfg).run(
                        items, lambda it: self._collect_one(*it), kind="fleet-collect",
                        shard_of=shard_of):
                    fresh[node] = entry
            with self._lock:
                self._nodes = fresh
                self._collected_at = time.time()
            for name, observer, method in (("capacity", self.capacity, "observe"),
                                           ("health", self.health, "observe"),
                                           ("throughput", self.autoscale_model,
                                            "observe_nodes")):
                if observer is None:
                    continue
                try:
                    getattr(observer, method)(fresh)
                except Exception:  # noqa: BLE001 — an observer never fails telemetry
                    logger.exception("%s observation failed", name)
            FLEET_NODES.set(float(len(fresh)))
            FLEET_COLLECT_DURATION.observe(time.monotonic() - t0)
            rollup = self.payload(max_age_s=None)
            if self.slo is not None:
                self.slo.ingest(rollup)
                self.slo.evaluate()
            return rollup

    def refresh_if_stale(self, max_age_s: float | None) -> None:
        """A pass only when the rollup is older than max_age_s. A caller that
        lost the race re-checks under the pass's lock and takes the winner's
        rollup instead of a second fan-out."""
        if max_age_s is None:
            return

        def _stale() -> bool:
            with self._lock:
                return (time.time() - self._collected_at) > max_age_s

        if not _stale():
            return
        with self._collect_mu:
            if _stale():
                self.collect_once()

    # --- the fleet model ---

    def payload(self, max_age_s: float | None = None) -> dict:
        """The /fleet answer; with `max_age_s` a stale or empty rollup is
        collected first (one pass at a time), so the route works without the
        background loop."""
        self.refresh_if_stale(max_age_s)
        with self._lock:
            nodes = {n: dict(e) for n, e in self._nodes.items()}
            at = self._collected_at
        now = time.time()
        for entry in nodes.values():
            if entry.get("stale"):
                # the age since the last successful pass (a node that never
                # answered has none: null, not ~0)
                entry["stale_age_s"] = (round(max(0.0, now - entry["collected_at"]), 1)
                                        if "collected_at" in entry else None)
        fleet = {"nodes": len(nodes), "mount_count": 0, "mount_success": 0.0,
                 "mount_error": 0.0, "warm_pool_hits": 0.0, "warm_pool_misses": 0.0,
                 "breakers_open": 0, "rollback_failures": 0.0}
        worst_p95 = 0.0
        for entry in nodes.values():
            mount = entry.get("mount") or {}
            fleet["mount_count"] += mount.get("count", 0)
            fleet["mount_success"] += mount.get("success", 0.0)
            fleet["mount_error"] += mount.get("error", 0.0)
            warm = entry.get("warm_pool") or {}
            fleet["warm_pool_hits"] += warm.get("hits", 0.0)
            fleet["warm_pool_misses"] += warm.get("misses", 0.0)
            fleet["rollback_failures"] += entry.get("rollback_failures", 0.0)
            if entry.get("breaker") == "open":
                fleet["breakers_open"] += 1
            worst_p95 = max(worst_p95, mount.get("p95_ms", 0.0))
        lookups = fleet["warm_pool_hits"] + fleet["warm_pool_misses"]
        fleet["warm_pool_hit_rate"] = (round(fleet["warm_pool_hits"] / lookups, 4)
                                       if lookups else 0.0)
        fleet["worst_node_p95_ms"] = worst_p95
        # the fleet's quantiles from the nodes' histograms merged bound by bound
        merged: dict[float, float] = {}
        merged_count = 0.0
        for entry in nodes.values():
            mount = entry.get("mount") or {}
            for bound, cum in mount.get("buckets") or []:
                merged[float(bound)] = merged.get(float(bound), 0.0) + cum
            merged_count += mount.get("count", 0)
        merged_hist = {"buckets": [[b, merged[b]] for b in sorted(merged)],
                       "count": merged_count}
        fleet["p50_ms"] = _hist_quantile_ms(merged_hist, 0.50)
        fleet["p95_ms"] = _hist_quantile_ms(merged_hist, 0.95)
        fleet["mount_buckets"] = merged_hist["buckets"]
        master = {}
        for name, key in _MASTER_COUNTER_NAMES:
            metric = REGISTRY.find(name)
            master[key] = metric.total() if isinstance(metric, Counter) else 0.0
        payload = {
            "at": round(at, 3),
            "interval_s": self.interval_s,
            "nodes": nodes,
            "fleet": fleet,
            "master": master,
            "tenants_fleet": tenants_fleet_rollup(merge_tenants(nodes)),
        }
        if self.shards is not None and self.shards.active():
            payload["shard"] = {"replica": self.shards.replica_id,
                                "shardCount": self.shards.shard_count,
                                "ownedShards": sorted(self.shards.owned_shards())}
        return payload

    def tenants_payload(self, max_age_s: float | None = None) -> dict:
        """The /tenants answer: each tenant's disruption ledger (steps,
        tokens/s, queue depth, minutes, windows by cause with their
        p50/p95), each window with a trace id linked to /trace/<id> and
        whether this master's ring still holds it."""
        self.refresh_if_stale(max_age_s)
        with self._lock:
            nodes = {n: dict(e) for n, e in self._nodes.items()}
            at = self._collected_at
        merged = merge_tenants(nodes)
        tenants: dict[str, dict] = {}
        for tenant, snap in sorted(merged.items()):
            dis = snap.get("disruption") or {}
            windows = []
            for w in dis.get("windows") or []:
                entry = dict(w)
                tid = entry.get("trace_id") or ""
                if tid:
                    entry["trace"] = f"/trace/{tid}"
                    entry["trace_resolves"] = trace.trace_payload(tid) is not None
                windows.append(entry)
            by_cause = {}
            for cause, agg in (dis.get("by_cause") or {}).items():
                hist = {"buckets": [[float(b), float(c)] for b, c in agg.get("buckets") or []],
                        "count": float(agg.get("windows", 0))}
                by_cause[cause] = {"windows": agg.get("windows", 0),
                                   "seconds": agg.get("seconds", 0.0),
                                   "p50_ms": _hist_quantile_ms(hist, 0.50),
                                   "p95_ms": _hist_quantile_ms(hist, 0.95)}
            tenants[tenant] = {
                "node": snap.get("node", ""),
                "namespace": snap.get("namespace", ""),
                "pod": snap.get("pod", ""),
                "at": snap.get("at"),
                "steps": (snap.get("steps") or {}).get("count", 0),
                "tokens_per_s": snap.get("tokens_per_s", 0.0),
                "queue_depth": snap.get("queue_depth"),
                "minutes": snap.get("minutes") or {},
                "disruption": {"open": dis.get("open") or [], "windows": windows,
                               "by_cause": by_cause,
                               "total_windows": dis.get("total_windows", 0),
                               "total_seconds": dis.get("total_seconds", 0.0)},
            }
        return {"at": round(at, 3), "tenants": tenants, "fleet": tenants_fleet_rollup(merged)}

    # --- the poll loop (master/main.py) ---

    def start(self) -> "FleetCollector":
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(target=self._loop, name="fleet-collector",
                                                daemon=True)
                self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                # background maintenance: its spans deferred and dropped
                with trace.deferred():
                    self.collect_once()
            except Exception as exc:  # noqa: BLE001 — the loop stays up
                logger.warning("fleet collection pass failed: %s", exc)
            self._stop.wait(self.interval_s)
