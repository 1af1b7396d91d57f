"""The port's metrics cardinality, held to the reference's guard
(``tests/test_metrics_cardinality.py``).

A fake-cluster run of the control plane through every surface of the
fleet planes (``entry.fleet_check`` on the CPU: adds and removes over HTTP
and gRPC, the collector and its scrape fallback, /fleet, /slo, /tenants,
/trace/<id>, /metrics, the ops port) must leave the exposition within the
reference's series budget, with no trace id in a label. The tenant store,
the trace plane, the fleet collector over many nodes and the device-access
table grow the exposition only by their fixed series, however many tenants,
spans, traces and nodes go through them.
"""

from __future__ import annotations

import json

import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu_torch.cgroup import ebpf
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.utils.metrics import REGISTRY

#: the reference's per-daemon budget (sample lines, comments excluded)
SERIES_BUDGET = 400


@pytest.fixture
def device_table():
    ebpf.DEVICE_TELEMETRY.reset()
    yield ebpf.DEVICE_TELEMETRY
    ebpf.DEVICE_TELEMETRY.reset()


def test_a_fake_cluster_run_stays_within_the_series_budget(device_table):
    from gpumounter_tpu_torch import entry
    from gpumounter_tpu_torch.torchside.telemetry import TenantTelemetry

    def tenant(uuids, dev_dir, url, token):
        tel = TenantTelemetry("default/card-tenant", pod="card-tenant", token=token)
        with tel.step(tokens=1.0):
            pass
        assert tel.publish(url)
        return {"tenant": tel.tenant, "steps": 1}

    REGISTRY.reset_all()
    flows = entry.fleet_check("cpu", repeats=2, on_mounted=tenant)["fake"]
    count = REGISTRY.series_count()
    assert count <= SERIES_BUDGET, (
        f"the exposition grew to {count} series (budget {SERIES_BUDGET}): an unbounded label?")
    classic = REGISTRY.render()
    assert not any(tid in classic for tid in flows["trace_ids"])
    assert "card-tenant" not in classic


def test_the_tenant_store_folds_past_its_cap_and_labels_no_tenant():
    from gpumounter_tpu_torch.obs.tenants import OVERFLOW_TENANT, TENANT_SCHEMA, TenantStore
    before = REGISTRY.series_count()
    store = TenantStore(max_tenants=16)
    for i in range(16 * 3):
        store.ingest({"schema": TENANT_SCHEMA, "tenant": f"churn/p-{i}", "at": float(i)})
    exported = store.export()
    assert len(exported) == store.max_tenants + 1
    assert exported[OVERFLOW_TENANT]["folded_tenants"] == 2 * 16
    assert REGISTRY.series_count() - before <= 3  # the unlabeled three


def test_the_trace_plane_grows_only_its_fixed_series():
    from gpumounter_tpu_torch.obs import trace as trace_mod
    from gpumounter_tpu_torch.obs.assembly import RemoteSpanStore
    from gpumounter_tpu_torch.obs.flight import FLIGHT, KINDS
    before = REGISTRY.series_count()
    tracer = trace_mod.Tracer(ring_capacity=64)
    for i in range(500):
        with trace_mod.span(f"op-{i % 7}", tracer=tracer):
            pass
    store = RemoteSpanStore(capacity=64)
    store.ingest("node-x", tracer.ring.snapshot())
    for kind in sorted(KINDS) + ["unheard-of-kind"]:
        FLIGHT.record(kind, "cardinality drill", trace_id=f"t-{kind}")
    grown = REGISTRY.series_count() - before
    assert grown <= 3 + len(KINDS), f"the trace plane grew {grown} series"


def test_the_fleet_collector_over_many_nodes_grows_only_its_fixed_series():
    """Node names ride the JSON plane: 200 nodes, each once answering and
    once not, add the collector's outcomes (3 values), its nodes gauge and
    its duration histogram, and nothing a node."""
    from gpumounter_tpu_torch.obs import fleet
    from gpumounter_tpu_torch.obs.assembly import RemoteSpanStore
    from gpumounter_tpu_torch.rpc import api
    from gpumounter_tpu_torch.rpc.resilience import RpcCallError
    snap = json.dumps(fleet.worker_telemetry_snapshot(cfg=Config(span_export_max=0)))
    nodes = {f"node-{i:03d}": f"10.1.{i // 250}.{i % 250}" for i in range(200)}
    down: set[str] = set()

    class Workers:
        def registry_snapshot(self):
            return dict(nodes)

    class Client:
        def __init__(self, address):
            self.ip = address.rsplit(":", 1)[0]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def collect_telemetry(self, quarantined=False):
            if self.ip in down:
                raise RpcCallError("gone", "UNAVAILABLE")
            return api.CollectTelemetryResponse(telemetry=snap)

    collector = fleet.FleetCollector(Workers(), Client, cfg=Config(), span_store=RemoteSpanStore())
    collector.collect_once()  # registers the pass's series
    before = REGISTRY.series_count()
    down.update(list(nodes.values())[::2])
    rollup = collector.collect_once()
    assert len(rollup["nodes"]) == 200 and sum(e.get("stale", False)
                                               for e in rollup["nodes"].values()) == 100
    assert REGISTRY.series_count() - before <= 1  # the "error" outcome


def test_the_device_access_table_folds_past_its_cap(device_table):
    before = REGISTRY.series_count()
    for i in range(device_table.max_tenants * 3):
        device_table.record(f"churn/pod-{i}", "grant")
    counts = device_table.counts()
    assert len({t for t, _ in counts}) == device_table.max_tenants + 1
    assert counts[(ebpf.TELEMETRY_OVERFLOW_TENANT, "grant")] == 2.0 * device_table.max_tenants
    assert REGISTRY.series_count() - before <= device_table.max_tenants + 1


def test_capacity_and_shares_over_many_nodes_and_tenants_grow_only_their_fixed_series():
    """/capacity and /shares carry node names, GPU indices and tenants on the
    JSON plane only, as the reference's: 200 nodes of 8 GPUs observed and
    served, and 300 shares of 150 tenants over 100 GPUs booked, admitted and
    served, add the plane's two gauges and two counters and the shares'
    four series, and nothing a node, a GPU or a tenant."""
    from gpumounter_tpu_torch.obs import capacity
    from gpumounter_tpu_torch.vchip import ShareRegistry, SharePacker

    class Fleet:
        def __init__(self, nodes):
            self.nodes = nodes

        def payload(self, max_age_s=None):
            return {"at": 1.0, "nodes": self.nodes}

    nodes = {f"node-{i:03d}": {"capacity": {
        "schema": capacity.CAPACITY_SCHEMA, "total": 8, "free": list(range(i % 9)),
        "warm": [], "fenced": [], "held": {str(g): f"ns/p-{i}-{g}" for g in range(i % 9, 8)},
        "warm_ready": 0, "ownership_known": True}} for i in range(200)}
    cfg = Config()
    registry = ShareRegistry(cfg=cfg)
    packer = SharePacker(registry, cfg=cfg)
    plane = capacity.CapacityPlane(Fleet(nodes), cfg=cfg, shares=registry)
    plane.observe(nodes)
    packer.admit("churn", "warmup", "decode", 1, 10, inventory={"GPU-x": "node-000"})
    before = REGISTRY.series_count()
    for i in range(150):
        packer.admit("churn", f"tenant-{i}", "prefill" if i % 2 else "decode", 2, 30,
                     inventory={f"GPU-{(i * 2 + k) % 100:03d}": f"node-{(i + k) % 200:03d}"
                                for k in range(2)})
    plane.observe(nodes)
    payload = plane.payload()
    assert len(payload["nodes"]) == 200 and payload["shares"]["shares"] == 301
    assert len(registry.payload()["shares"]) == 301
    assert REGISTRY.series_count() - before == 0
    classic = REGISTRY.render()
    assert "node-1" not in classic and "tenant-1" not in classic and "GPU-0" not in classic
    assert {"tpumounter_capacity_free_chips", "tpumounter_vchip_shares_active"} <= {
        line.split(" ")[0] for line in classic.splitlines() if not line.startswith("#")}


def test_autoscale_plane_series_are_bounded():
    """The reference's autoscale guard: 300 tenants under intents, five
    passes, an operator pause, a refused pass and the resume grow the
    exposition only by the autoscaler's fixed series (decisions by action,
    skips by SKIP_REASONS, refusals by the five causes, the passes counter,
    the paused gauge); no tenant name, trace id or cooldown key becomes a
    label, and the model's table stops at its bound."""
    from gpumounter_tpu_torch.autoscale import (
        SKIP_REASONS,
        AutoscaleController,
        AutoscaleRefused,
    )
    from gpumounter_tpu_torch.elastic.intents import Intent

    class Store:
        def __init__(self, intents):
            self.intents = intents

        def put(self, namespace, pod_name, intent):
            self.intents[(namespace, pod_name)] = intent
            return intent

        def list(self):
            return [(ns, pod, i) for (ns, pod), i in sorted(self.intents.items())]

    class Elastic:
        def __init__(self, store):
            self.store = store

        def enqueue(self, namespace, pod_name):
            pass

    class Fleet:
        """One node publishing one sparse snapshot each for 300 tenants."""

        def payload(self, max_age_s=None):
            tenants = {f"churn/as-{i}": {"steps": {"count": 10 + i}, "tokens_total": 100.0 + i,
                                         "tokens_per_s": 50.0, "queue_depth": 40.0,
                                         "at": 1000.0} for i in range(300)}
            return {"nodes": {"card-as-host": {
                "capacity": {"free": list(range(8)), "held": {}, "warm": [], "fenced": [],
                             "total": 8},
                "tenants": tenants}}}

    before = REGISTRY.series_count()
    intents = {("churn", f"as-{i}"): Intent(desired_chips=2, min_chips=1) for i in range(300)}
    ctrl = AutoscaleController(Elastic(Store(intents)), None, Fleet(), cfg=Config(),
                               clock=lambda: 1010.0)
    for _ in range(5):
        ctrl.evaluate_once()
    ctrl.pause(actor="card-drill")
    with pytest.raises(AutoscaleRefused):
        ctrl.evaluate_once()
    ctrl.resume(actor="card-drill")
    grown = REGISTRY.series_count() - before
    assert grown <= 2 + len(SKIP_REASONS) + 5 + 2, (
        f"the autoscaler grew {grown} series: an unbounded label?")
    classic = REGISTRY.render()
    assert "churn/as-" not in classic and "card-as-host" not in classic
    assert ctrl.model.payload(now=1010.0)["tracked"] <= Config().autoscale_max_tenants
