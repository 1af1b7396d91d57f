"""The metrics registry (``utils/metrics.py``) against the reference's.

The same seeded ops (inc, set, dec, observe with and without an exemplar)
on a fresh ``Registry`` of each package must render the same bytes, in the
classic exposition and in OpenMetrics, and give the same snapshots,
quantiles and series counts. Every series the port registers has the
reference's name, type and help, so dashboards read either.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import pytest

from gpumounter_tpu.utils import metrics as ref_metrics
from gpumounter_tpu_torch.utils import metrics

BUCKETS = (0.001, 0.01, 0.1, 0.5, 1.0, 2.5, 10.0)
KEYS = ("phase", "result", "worker")


def _labels(rng) -> dict[str, str]:
    keys = [k for k in KEYS if rng.random() < 0.5]
    return {k: str(rng.choice(["a", "b", "grant", "success", "10.0.0.1:1200"])) for k in keys}


def _drive(mod, seed: int):
    """A fresh registry of `mod` after the seeded ops."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    counter = reg.counter("tpumounter_test_total", "A counter")
    gauge = reg.gauge("tpumounter_test_gauge", "A gauge")
    hist = reg.histogram("tpumounter_test_seconds", "A histogram")
    custom = reg.histogram("tpumounter_test_custom_seconds", "Custom buckets", BUCKETS)
    reg.counter("tpumounter_test_untouched_total", "Never incremented")
    for _ in range(300):
        op = int(rng.integers(6))
        labels = _labels(rng)
        value = float(rng.choice([0.0, 0.001, 0.0049, 0.3, 1.0, 7.25, 31.0, 1e3]))
        if op == 0:
            counter.inc(float(rng.integers(1, 4)), **labels)
        elif op == 1:
            gauge.set(value, **labels)
        elif op == 2:
            gauge.dec(1.5, **labels)
        elif op == 3:
            hist.observe(value, **labels)
        elif op == 4:
            custom.observe(value, trace_id=f"t{int(rng.integers(100)):04d}", **labels)
        else:
            hist.observe(value, trace_id="", **labels)
    return reg, counter, gauge, hist, custom


@pytest.fixture()
def frozen_clock(monkeypatch):
    """Exemplars carry the wall clock: the same instant on both sides."""
    for mod in (metrics, ref_metrics):
        monkeypatch.setattr(mod.time, "time", lambda: 1_760_000_000.123456)


@pytest.mark.parametrize("seed", range(6))
def test_the_same_ops_render_the_same_bytes(seed, frozen_clock):
    port, ref = _drive(metrics, seed), _drive(ref_metrics, seed)
    for openmetrics in (False, True):
        assert port[0].render(openmetrics=openmetrics) == ref[0].render(openmetrics=openmetrics)
    assert "# {trace_id=" in port[0].render(openmetrics=True)
    assert "# {trace_id=" not in port[0].render()
    assert port[0].series_count() == ref[0].series_count()
    for got, want in zip(port[1:], ref[1:]):
        assert got.snapshot() == want.snapshot()
    for got, want in zip(port[3:], ref[3:]):
        for labels in [dict(k) for k in got.snapshot()] + [{"phase": "absent"}]:
            for q in (0.0, 0.5, 0.9, 0.99, 1.0):
                assert got.quantile(q, **labels) == want.quantile(q, **labels)
    assert port[1].total() == ref[1].total()
    port[0].reset_all()
    ref[0].reset_all()
    assert port[0].render() == ref[0].render()
    assert port[0].find("tpumounter_test_gauge") is port[2]
    assert port[0].find("absent") is None


@pytest.mark.parametrize("seed", range(4))
def test_estimate_quantile_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    buckets = tuple(sorted(set(float(x) for x in rng.uniform(0, 10, 8))))
    per_bucket = rng.integers(0, 5, len(buckets) + 1)
    counts = list(np.cumsum(per_bucket).astype(int))
    for q in np.linspace(0, 1, 21):
        assert metrics.estimate_quantile(buckets, counts, q) == \
            ref_metrics.estimate_quantile(buckets, counts, q)
    assert metrics.estimate_quantile(buckets, [0] * (len(buckets) + 1), 0.5) == 0.0


def test_label_keys_and_formatting_equal_the_reference():
    assert metrics.ALLOWED_LABEL_KEYS == ref_metrics.ALLOWED_LABEL_KEYS
    for value in (1.0, 30, 0.005, 2.5, 1e-9):
        assert metrics._fmt_float(value) == ref_metrics._fmt_float(value)
    assert metrics._fmt_labels({"b": "2", "a": "1"}) == ref_metrics._fmt_labels({"b": "2",
                                                                                "a": "1"})


# The port's modules that register series, beside the reference's that do.
PORT_MODULES = ["cgroup.ebpf", "cgroup.policy", "rpc.resilience", "rpc.client", "k8s.fake",
                "worker.server", "worker.mounter", "worker.ledger", "worker.resync",
                "utils.fanout", "faults.failpoints", "obs.trace", "obs.flight", "k8s.health",
                "store.writebehind", "store.cache", "store.watch", "master.shard",
                "allocator.pool", "obs.tenants", "obs.assembly", "obs.fleet", "obs.slo",
                "health.plane", "recovery.controller", "elastic.reconciler",
                "migrate.orchestrator", "obs.capacity", "vchip.shares"]


def test_every_series_of_the_port_is_the_references():
    for name in PORT_MODULES:
        importlib.import_module(f"gpumounter_tpu_torch.{name}")
        importlib.import_module(f"gpumounter_tpu.{name}")
    seen = []
    for metric in metrics.REGISTRY._metrics:
        want = ref_metrics.REGISTRY.find(metric.name)
        assert want is not None, metric.name
        assert (type(metric).__name__, metric.help) == (type(want).__name__, want.help)
        seen.append(metric.name)
    assert len(seen) == len(set(seen))
    assert {"tpumounter_mount_total", "tpumounter_unmount_total",
            "tpumounter_mount_latency_seconds", "tpumounter_phase_latency_seconds",
            "tpumounter_mount_rollback_failures_total", "tpumounter_ebpf_program_swaps_total",
            "tpumounter_ebpf_map_grants_total", "tpumounter_device_access_total",
            "tpumounter_vchip_throttled_total", "tpumounter_worker_breaker_open",
            "tpumounter_worker_breaker_trips_total", "tpumounter_rpc_retries_total",
            "tpumounter_channel_pool_hits_total", "tpumounter_channel_pool_misses_total",
            "tpumounter_channel_pool_evictions_total", "tpumounter_channel_pool_size",
            "tpumounter_watch_backlog_evictions_total",
            "tpumounter_slave_release_failures_total", "tpumounter_fanout_tasks_total",
            "tpumounter_fanout_inflight", "tpumounter_fanout_shard_waits_total",
            "tpumounter_failpoint_fires_total", "tpumounter_trace_ring_evictions_total",
            "tpumounter_flight_records_total", "tpumounter_fenced_writes_total",
            "tpumounter_slave_release_deferred_total", "tpumounter_ledger_appends_total",
            "tpumounter_ledger_open_transactions", "tpumounter_ledger_compactions_total",
            "tpumounter_ledger_replays_total", "tpumounter_api_health_state",
            "tpumounter_api_health_transitions_total", "tpumounter_api_call_failures_total",
            "tpumounter_writebehind_pending", "tpumounter_writebehind_queued_total",
            "tpumounter_writebehind_replayed_total", "tpumounter_store_stale_reads_total",
            "tpumounter_store_deferred_writes_total", "tpumounter_watch_store_events_total",
            "tpumounter_watch_store_relists_total", "tpumounter_watch_store_fallback_reads_total",
            "tpumounter_watch_store_synced", "tpumounter_shards_owned",
            "tpumounter_shard_takeovers_total", "tpumounter_shard_renew_failures_total",
            "tpumounter_warm_pool_hits_total", "tpumounter_warm_pool_misses_total",
            "tpumounter_warm_pool_ready", "tpumounter_warm_pool_refills_total",
            "tpumounter_warm_pool_refill_failures_total",
            "tpumounter_warm_pool_drained_total", "tpumounter_tenant_snapshots_total",
            "tpumounter_tenant_snapshots_rejected_total", "tpumounter_tenants_tracked",
            "tpumounter_remote_spans_ingested_total", "tpumounter_remote_span_evictions_total",
            "tpumounter_fleet_collections_total", "tpumounter_fleet_nodes",
            "tpumounter_fleet_collect_duration_seconds", "tpumounter_slo_burn_rate",
            "tpumounter_slo_breaches_total", "tpumounter_slo_breached",
            "tpumounter_node_health_state", "tpumounter_canary_probes_total",
            "tpumounter_canary_failures_total", "tpumounter_quarantine_transitions_total",
            "tpumounter_health_scorer_skips_total", "tpumounter_quarantine_budget_denials_total",
            "tpumounter_recovery_nodes_tracked", "tpumounter_recovery_nodes_suspect",
            "tpumounter_nodes_evacuated_total", "tpumounter_evacuated_bookings_total",
            "tpumounter_evacuated_intents_total",
            "tpumounter_reconcile_duration_seconds", "tpumounter_reconcile_queue_depth",
            "tpumounter_chips_healed_total", "tpumounter_chips_heal_failures_total",
            "tpumounter_intents_registered", "tpumounter_migrations_total",
            "tpumounter_migration_phase_duration_seconds",
            "tpumounter_migration_downtime_seconds",
            "tpumounter_capacity_free_chips", "tpumounter_capacity_fragmentation_index",
            "tpumounter_capacity_size_feasible_total",
            "tpumounter_capacity_size_infeasible_total",
            "tpumounter_vchip_shares_active", "tpumounter_vchip_shared_chips",
            "tpumounter_vchip_share_admits_total",
            "tpumounter_vchip_share_releases_total"} == set(seen)


# --- the series of the modules ported before the registry ---

def _snapshots(*series) -> list[dict]:
    return [s.snapshot() for s in series]


def test_the_breaker_series_move_as_the_reference():
    """Trips count transitions to open; a failed half-open probe re-opens
    without a trip; a success or a prune puts the gauge back to 0."""
    from gpumounter_tpu.rpc import resilience as ref_res
    from gpumounter_tpu_torch.rpc import resilience as res
    for mod in (res, ref_res):
        mod.BREAKER_OPEN.reset()
        mod.BREAKER_TRIPS.reset()
    breakers = [mod.CircuitBreaker(failure_threshold=2, reset_s=0.0) for mod in (res, ref_res)]
    opened = [[], []]
    for b, log in zip(breakers, opened):
        b.on_open = log.append
    steps = [("fail", "w1"), ("fail", "w1"), ("allow", "w1"), ("fail", "w1"), ("allow", "w1"),
             ("ok", "w1"), ("fail", "w2"), ("fail", "w2"), ("prune", "w1")]
    for op, key in steps:
        for b in breakers:
            {"fail": b.record_failure, "ok": b.record_success, "allow": b.allow,
             "prune": lambda k, b=b: b.prune([k])}[op](key)
        assert _snapshots(res.BREAKER_OPEN, res.BREAKER_TRIPS) == \
            _snapshots(ref_res.BREAKER_OPEN, ref_res.BREAKER_TRIPS), (op, key)
    assert opened[0] == opened[1] == ["w1", "w1", "w2"]
    assert res.BREAKER_TRIPS.get(worker="w1") == 1 and res.BREAKER_OPEN.get(worker="w2") == 0


def test_the_channel_pool_series_move_as_the_reference():
    from gpumounter_tpu.config import Config as RefConfig
    from gpumounter_tpu.rpc import client as ref_client
    from gpumounter_tpu_torch.config import Config
    from gpumounter_tpu_torch.rpc import client
    series = ("CHANNEL_POOL_HITS", "CHANNEL_POOL_MISSES", "CHANNEL_POOL_EVICTIONS",
              "CHANNEL_POOL_SIZE")
    for mod in (client, ref_client):
        for name in series:
            getattr(mod, name).reset()
    pools = [client.ChannelPool(Config(channel_idle_evict_s=0.0)),
             ref_client.ChannelPool(RefConfig().replace(channel_idle_evict_s=0.0))]
    steps = [("channel", "127.0.0.1:1"), ("channel", "127.0.0.1:1"), ("release", "127.0.0.1:1"),
             ("channel", "127.0.0.1:2"), ("invalidate", "127.0.0.1:1"),
             ("retain", "127.0.0.1:3"), ("channel", "127.0.0.1:3"), ("close_all", None)]
    for op, address in steps:
        for pool in pools:
            if op == "retain":
                pool.retain([address])
            elif op == "close_all":
                pool.close_all()
            else:
                getattr(pool, op)(address)
        assert [getattr(client, n).snapshot() for n in series] == \
            [getattr(ref_client, n).snapshot() for n in series], op
    assert client.CHANNEL_POOL_EVICTIONS.snapshot() == {
        (("reason", "invalidated"),): 1.0, (("reason", "pruned"),): 1.0,
        (("reason", "shutdown"),): 1.0}


def test_a_retried_call_counts_its_retries():
    """A worker that refuses the connection: each attempt after the first
    is one retry of the method."""
    from gpumounter_tpu_torch.config import Config
    from gpumounter_tpu_torch.rpc import api
    from gpumounter_tpu_torch.rpc.client import WorkerClient
    from gpumounter_tpu_torch.rpc.resilience import RPC_RETRIES, RpcCallError
    RPC_RETRIES.reset()
    cfg = Config(rpc_max_attempts=3, rpc_retry_base_s=0.001, rpc_retry_cap_s=0.001,
                 rpc_add_timeout_s=2.0)
    with WorkerClient("127.0.0.1:1", cfg=cfg) as worker:
        with pytest.raises(RpcCallError):
            worker.add_gpu("p", "default", 1)
    assert RPC_RETRIES.snapshot() == {(("method", api.ADD_METHOD),): 2.0}


def test_watch_backlog_evictions_count_as_the_reference():
    """Events trimmed past an open watcher's cursor count; history no open
    watcher needs does not."""
    from gpumounter_tpu.config import Config as RefConfig
    from gpumounter_tpu.k8s import fake as ref_fake
    from gpumounter_tpu_torch.k8s import fake
    from gpumounter_tpu_torch.config import Config
    seen = []
    for mod, kube in ((fake, fake.FakeKubeClient(cfg=Config(watch_backlog_events=64))),
                      (ref_fake, ref_fake.FakeKubeClient(
                          cfg=RefConfig().replace(watch_backlog_events=64)))):
        mod.WATCH_BACKLOG_EVICTIONS.reset()
        for i in range(80):  # no watcher yet: trimming is free
            kube.create_pod("default", {"metadata": {"name": f"early-{i}"}})
        counts = [mod.WATCH_BACKLOG_EVICTIONS.get()]
        watch = kube.watch_pods("default", timeout_s=5.0)
        kube.create_pod("default", {"metadata": {"name": "first"}})
        assert next(watch)[1]["metadata"]["name"] == "first"
        for i in range(100):
            kube.create_pod("default", {"metadata": {"name": f"late-{i}"}})
        counts.append(mod.WATCH_BACKLOG_EVICTIONS.get())
        watch.close()
        kube.create_pod("default", {"metadata": {"name": "after"}})
        counts.append(mod.WATCH_BACKLOG_EVICTIONS.get())
        seen.append(counts)
    # 100 events past a backlog of 64 leave 36 unread ones behind, and
    # "first" too: the watcher's cursor moves on when it asks for more.
    assert seen[0] == seen[1] == [0.0, 37.0, 37.0]


def test_a_failed_slave_release_counts(tmp_path, monkeypatch):
    from gpumounter_tpu_torch.rpc import api
    from gpumounter_tpu_torch.testing.cluster import FakeCluster
    from gpumounter_tpu_torch.worker.server import SLAVE_RELEASE_FAILURES, ServiceError
    SLAVE_RELEASE_FAILURES.reset()
    cluster = FakeCluster.with_fake_gpus(str(tmp_path / "host"), 2)
    os.makedirs(tmp_path / "dev")
    service = cluster.service(str(tmp_path / "dev"))
    cluster.add_target_pod("trainer")
    added = service.add_gpu(api.AddGPURequest("trainer", "default", 2))

    def refuse(names, wait=True):
        raise RuntimeError("the API server is away")

    monkeypatch.setattr(service.allocator, "delete_slave_pods", refuse)
    with pytest.raises(ServiceError, match="not released"):
        service.remove_gpu(api.RemoveGPURequest("trainer", "default", added.uuids))
    assert SLAVE_RELEASE_FAILURES.get() == 2
