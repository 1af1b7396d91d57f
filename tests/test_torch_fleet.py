"""The fleet telemetry plane (``gpumounter_tpu_torch/obs/fleet.py``) against
the reference's (``gpumounter_tpu/obs/fleet.py``).

The same seeded observations go into a fresh registry of each package, and
the snapshots, their JSON round trip, the scrape of one exposition, the node
rollups, the tenant merges and the quantiles must be equal. Two collectors,
one of each package, over the same stub workers must give equal rollups; the
port's collector keeps a stale entry, collects once for concurrent stale
readers, and scrapes a worker without the RPC (over real gRPC: its
UNIMPLEMENTED) and one whose payload does not parse; the master's passes over
a worker that is down leave the next add through it unrefused. The
CollectTelemetry messages encode to the reference's bytes, and the request's
``quarantined`` drains the worker's warm pool and lets it refill.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time

import numpy as np
import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.cgroup import ebpf as ref_ebpf
from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.obs import fleet as ref_fleet
from gpumounter_tpu.rpc import api as ref_api
from gpumounter_tpu.utils import metrics as ref_metrics
from gpumounter_tpu_torch.cgroup import ebpf
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.obs import assembly, fleet
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.rpc.resilience import RpcCallError
from gpumounter_tpu_torch.utils import metrics

SIDES = {"reference": (ref_fleet, ref_metrics, ref_ebpf), "port": (fleet, metrics, ebpf)}
NOW = 1_760_000_000.25
LATENCY = "tpumounter_mount_latency_seconds"


@pytest.fixture(autouse=True)
def device_tables():
    """Both packages' device-access tables empty around each test."""
    for mod in (ref_ebpf, ebpf):
        mod.DEVICE_TELEMETRY.reset()
        mod.DEVICE_TELEMETRY._readers.clear()
    yield
    for mod in (ref_ebpf, ebpf):
        mod.DEVICE_TELEMETRY.reset()
        mod.DEVICE_TELEMETRY._readers.clear()


@pytest.fixture
def frozen_clock(monkeypatch):
    """Snapshots and exemplars carry the wall clock: one instant for both."""
    monkeypatch.setattr(time, "time", lambda: NOW)


def _drive(name: str, seed: int):
    """A fresh registry of one package with the snapshot's instruments,
    after the same seeded mounts, counters and device-access records."""
    _, mmod, emod = SIDES[name]
    rng = np.random.default_rng(seed)
    reg = mmod.Registry()
    hist = reg.histogram(LATENCY, "End-to-end hot-mount latency")
    counters = {name: reg.counter(name, "c") for name, _ in fleet._COUNTER_NAMES}
    for i in range(40):
        value = float(rng.choice([0.002, 0.02, 0.04, 0.07, 0.3, 1.5, 40.0]))
        hist.observe(value, trace_id=f"{int(rng.integers(1 << 30)):032x}" if i % 3 else "")
        counters["tpumounter_mount_total"].inc(
            float(rng.integers(1, 3)), result=str(rng.choice(["success", "error"])))
        counters[str(rng.choice([n for n, _ in fleet._COUNTER_NAMES[1:]]))].inc()
        emod.DEVICE_TELEMETRY.record(f"ns/p-{int(rng.integers(5))}",
                                     str(rng.choice(["grant", "deny", "open"])),
                                     int(rng.integers(1, 4)))
    return reg


@pytest.mark.parametrize("seed", range(3))
def test_the_snapshot_is_the_references_and_roundtrips_through_json(seed, frozen_clock):
    snaps = {name: SIDES[name][0].worker_telemetry_snapshot(registry=_drive(name, seed))
             for name in SIDES}
    assert json.loads(json.dumps(snaps["port"])) == json.loads(json.dumps(snaps["reference"]))
    doc = fleet.parse_telemetry(json.dumps(snaps["port"]))
    assert doc == json.loads(json.dumps(snaps["port"]))
    assert doc["schema"] == "tpumounter-telemetry/1" and doc["mount_latency"]["count"] == 40
    assert doc["mount_latency"]["exemplars"] and doc["device_access"]


def test_the_snapshot_carries_the_newest_spans_up_to_span_export_max():
    from gpumounter_tpu_torch.obs import trace
    for i in range(7):
        with trace.span(f"op.{i}"):
            pass
    cfg = Config(span_export_max=3, node_name="gpu-node-9")
    snap = fleet.worker_telemetry_snapshot(cfg=cfg)
    assert [s["name"] for s in snap["spans"]] == ["op.4", "op.5", "op.6"]
    assert snap["node"] == "gpu-node-9"
    assert fleet.worker_telemetry_snapshot(cfg=Config(span_export_max=0))["spans"] == []


@pytest.mark.parametrize("bad", [
    "", None, 7, b"bytes", "not json", "[1, 2]", '"a string"',
    '{"schema": "some-other-schema/9"}', "{}",
])
def test_parse_telemetry_refuses_the_references_garbage(bad):
    assert ref_fleet.parse_telemetry(bad) is None
    assert fleet.parse_telemetry(bad) is None


@pytest.mark.parametrize("seed", range(3))
def test_one_exposition_scrapes_to_equal_snapshots(seed, frozen_clock):
    text = _drive("port", seed).render()
    text += "".join(f'tpumounter_device_access_total{{kind="{k}",tenant="{t}"}} {v}\n'
                    for (t, k), v in sorted(ebpf.DEVICE_TELEMETRY.counts().items()))
    text += "not a line at all {{{\n# HELP x y\nx{a=\"b\"} 1\n"
    got = {name: SIDES[name][0].snapshot_from_prometheus(text) for name in SIDES}
    assert got["port"] == got["reference"]
    assert got["port"]["mount_latency"]["count"] == 40 and got["port"]["device_access"]
    assert got["port"]["spans"] == [] and got["port"]["tenants"] == {}
    assert got["port"]["capacity"] is None
    junk = "# HELP x y\nx{a=\"b\"} 1\nnot a line at all {{{\nx 2\nx +Inf\n"
    assert fleet.parse_prometheus_text(junk) == ref_fleet.parse_prometheus_text(junk)


def _random_snapshot(rng, node: str) -> dict:
    bounds = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0)
    counts = np.cumsum(rng.integers(0, 6, len(bounds) + 1)).tolist()
    tenants = {}
    for i in range(int(rng.integers(0, 4))):
        causes = {c: {"windows": int(rng.integers(0, 4)), "seconds": float(rng.random() * 9),
                      "buckets": [[b, float(n)] for b, n in
                                  zip((0.5, 1.0, 2.5, 5.0), np.cumsum(rng.integers(0, 3, 4)))]}
                  for c in rng.choice(["migration", "heal", "stall"], 2, replace=False)}
        tenants[f"t-{i}"] = {"schema": "tpumounter-tenant/1", "tenant": f"t-{i}",
                             "at": float(rng.integers(0, 5)), "pod": f"p{i}",
                             "steps": {"count": int(rng.integers(0, 500))},
                             "minutes": {"total": int(rng.integers(0, 60)),
                                         "disrupted": int(rng.integers(0, 3))},
                             "disruption": {"total_windows": 2, "total_seconds": 1.5,
                                            "open": [{"cause": "stall"}] * int(rng.integers(2)),
                                            "by_cause": causes}}
    return {"schema": "tpumounter-telemetry/1", "node": node,
            "mount_latency": {"buckets": [[b, int(c)] for b, c in zip(bounds, counts)],
                              "count": int(counts[-1]), "sum": 1.0,
                              "exemplars": [{"le": 0.05, "trace_id": "ab" * 16, "value": 0.04,
                                             "at": NOW}]},
            "counters": {"mount_total": {"success": float(rng.integers(0, 9)),
                                         "error": float(rng.integers(0, 2))},
                         "warm_pool_hits": {"": float(rng.integers(0, 5))},
                         "warm_pool_misses": {"": float(rng.integers(0, 5))},
                         "rollback_failures": {}, "ebpf_program_swaps": {"": 1.0}},
            "device_access": {"ns/p": {"grant": 2.0}}, "tenants": tenants, "spans": []}


@pytest.mark.parametrize("seed", range(4))
def test_rollups_merges_and_quantiles_are_the_references(seed):
    rng = np.random.default_rng(seed)
    snaps = {f"n{i}": _random_snapshot(rng, f"n{i}") for i in range(3)}
    for snap in snaps.values():
        assert fleet._node_rollup(snap) == ref_fleet._node_rollup(snap)
        for q in (0.5, 0.95, 0.99):
            hist = snap["mount_latency"]
            assert fleet._hist_quantile_ms(hist, q) == ref_fleet._hist_quantile_ms(hist, q)
    nodes = {n: fleet._node_rollup(s) for n, s in snaps.items()}
    merged = fleet.merge_tenants(nodes)
    assert merged == ref_fleet.merge_tenants(nodes)
    assert fleet.tenants_fleet_rollup(merged) == ref_fleet.tenants_fleet_rollup(merged)


class _Workers:
    def __init__(self, nodes):
        self.nodes = nodes

    def registry_snapshot(self):
        return dict(self.nodes)


def _stub_client(answers, calls=None, delay=0.0):
    """A client factory whose collect_telemetry answers answers[ip] (a
    response, or an exception to raise)."""

    class _Client:
        def __init__(self, address):
            self.ip = address.rsplit(":", 1)[0]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def collect_telemetry(self, timeout_s=None, quarantined=False):
            if calls is not None:
                calls.append(self.ip)
            time.sleep(delay)
            answer = answers[self.ip]
            if isinstance(answer, Exception):
                raise answer
            return answer

    return _Client


def _unstamped(payload: dict) -> dict:
    out = json.loads(json.dumps(payload))
    out.pop("at")
    for entry in out["nodes"].values():
        entry.pop("collected_at", None)
    return out


@pytest.fixture()
def port_master_counters_zeroed():
    """The rollup's master counters are process-global in both packages;
    the reference's are zeroed after every test (``tests/conftest.py``), the
    port's hold what earlier tests of the worker left (the master, slice and
    transport tests trip breakers). Zeroed here, and put back after."""
    saved = []
    for name, _ in fleet._MASTER_COUNTER_NAMES:
        metric = metrics.REGISTRY.find(name)
        if metric is not None:
            saved.append((metric, metric.snapshot()))
            metric.reset()
    yield
    for metric, values in saved:
        metric.reset()
        metric._values.update(values)


def test_two_collectors_of_the_same_stub_fleet_roll_up_equal(port_master_counters_zeroed):
    rng = np.random.default_rng(7)
    snaps = {f"10.0.0.{i}": _random_snapshot(rng, f"n{i}") for i in range(1, 4)}
    workers = _Workers({f"n{i}": f"10.0.0.{i}" for i in range(1, 4)})
    payloads = {}
    for name, amod in (("reference", ref_api), ("port", api)):
        mod = SIDES[name][0]
        answers = {ip: amod.CollectTelemetryResponse(telemetry=json.dumps(s))
                   for ip, s in snaps.items()}
        cfg = (RefConfig().replace(fleet_scrape_interval_s=3600.0) if name == "reference"
               else Config(fleet_scrape_interval_s=3600.0))
        payloads[name] = _unstamped(
            mod.FleetCollector(workers, _stub_client(answers), cfg=cfg).collect_once())
    # the capacity plane's counters ride both rollups (no plane here: 0)
    for side in payloads.values():
        assert {k: side["master"][k] for k in ("slice_feasible", "slice_infeasible")} == \
            {"slice_feasible": 0.0, "slice_infeasible": 0.0}
    assert payloads["port"] == payloads["reference"]
    assert payloads["port"]["fleet"]["mount_count"] == sum(
        s["mount_latency"]["count"] for s in snaps.values())


def test_a_node_that_stops_answering_keeps_its_entry_marked_stale():
    snap = _random_snapshot(np.random.default_rng(3), "n1")
    answers = {"10.0.0.1": api.CollectTelemetryResponse(telemetry=json.dumps(snap))}
    collector = fleet.FleetCollector(_Workers({"n1": "10.0.0.1"}), _stub_client(answers),
                                     cfg=Config(fleet_scrape_interval_s=3600.0))
    first = collector.collect_once()["nodes"]["n1"]
    answers["10.0.0.1"] = RpcCallError("worker gone", "UNAVAILABLE")
    second = collector.collect_once()["nodes"]["n1"]
    assert second["stale"] is True and "worker gone" in second["error"]
    assert second["mount"] == first["mount"] and second["collected_at"] == first["collected_at"]
    assert second["stale_age_s"] >= 0.0
    never = fleet.FleetCollector(_Workers({"n1": "10.0.0.1"}), _stub_client(answers),
                                 cfg=Config()).collect_once()["nodes"]["n1"]
    assert never["stale"] is True and never["stale_age_s"] is None


def test_concurrent_stale_readers_share_one_pass():
    calls = []
    snap = fleet.worker_telemetry_snapshot()
    answers = {"10.0.0.1": api.CollectTelemetryResponse(telemetry=json.dumps(snap))}
    collector = fleet.FleetCollector(_Workers({"n1": "10.0.0.1"}),
                                     _stub_client(answers, calls, delay=0.15), cfg=Config())
    results = []
    threads = [threading.Thread(target=lambda: results.append(collector.payload(max_age_s=30.0)))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == ["10.0.0.1"]
    assert len(results) == 4 and all(set(r["nodes"]) == {"n1"} for r in results)


@pytest.fixture
def ops_port():
    from gpumounter_tpu_torch.worker.main import serve_ops
    cfg = Config(auth_mode="token", auth_token="fleet-test-mutate",
                 auth_read_token="fleet-test-read")
    httpd = serve_ops(0, cfg, host="127.0.0.1")
    yield cfg, httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()


def test_a_worker_without_the_rpc_is_scraped_through_its_ops_port(tmp_path, ops_port):
    """Over real gRPC: a worker built with include_telemetry=False answers
    UNIMPLEMENTED, and the collector scrapes its /metrics with the read
    token: the process's counters come through, no span, no tenant."""
    from gpumounter_tpu_torch.rpc.client import WorkerClient
    from gpumounter_tpu_torch.testing.cluster import FakeCluster
    from gpumounter_tpu_torch.worker.server import build_server
    cfg, port = ops_port
    cluster = FakeCluster.with_fake_gpus(str(tmp_path / "c"), 2)
    service = cluster.service(str(tmp_path / "dev"))
    server = build_server(service, address="127.0.0.1:0", include_telemetry=False)
    server.start()
    try:
        ccfg = dataclasses.replace(cfg, worker_port=server.bound_port, metrics_port=port)
        spans = assembly.RemoteSpanStore()
        collector = fleet.FleetCollector(
            _Workers({"n1": "127.0.0.1"}),
            lambda address: WorkerClient(address, token=cluster.cfg.auth_token, cfg=ccfg),
            cfg=ccfg, span_store=spans)
        entry = collector.collect_once()["nodes"]["n1"]
        with WorkerClient(f"127.0.0.1:{server.bound_port}", token=cluster.cfg.auth_token,
                          cfg=ccfg) as client:
            with pytest.raises(RpcCallError) as err:
                client.collect_telemetry()
        assert err.value.code == "UNIMPLEMENTED"
    finally:
        server.stop(None).wait()
        cluster.stop()
    assert entry["mode"] == "scrape" and "stale" not in entry
    assert entry["mount"]["success"] == metrics.MOUNT_TOTAL.get(result="success")
    assert entry["mount"]["count"] == sum(
        e["counts"][-1] for e in metrics.MOUNT_LATENCY.snapshot().values())
    assert entry["tenants"] == {} and entry["exemplars"] == [] and len(spans) == 0


def test_a_worker_down_for_a_pass_does_not_refuse_the_next_add(tmp_path):
    """Over real gRPC, the master's own collector and recovery controller:
    two passes of each over a worker that is not serving yet (a master
    started first, a worker restarting) mark its entry stale and the node
    suspect, count nothing against the mount path's breaker and leave its
    pooled channel alone, so the add once the worker serves answers 200 and
    the next pass is over the RPC."""
    from conftest import AUTH_HEADER

    from gpumounter_tpu_torch.master.app import MasterApp
    from gpumounter_tpu_torch.testing.cluster import FakeCluster
    from gpumounter_tpu_torch.worker.server import build_server
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cluster = FakeCluster.with_fake_gpus(str(tmp_path / "c"), 2)
    service = cluster.service(str(tmp_path / "dev"))
    cluster.register_worker()
    cluster.add_target_pod("late")
    app = MasterApp(cluster.kube, cfg=dataclasses.replace(cluster.cfg, worker_port=port))
    server = None
    try:
        for _ in range(2):
            entry = app.fleet.collect_once()["nodes"][cluster.node_name]
            assert entry["stale"] is True and entry["breaker"] == "closed", entry
        for _ in range(2):
            assert app.recovery.check_once()["evacuated"] == []
            assert app.recovery.payload()["nodes"][cluster.node_name]["status"] == "suspect"
        assert app.registry.breaker.state(f"127.0.0.1:{port}") == "closed"
        server = build_server(service, address=f"127.0.0.1:{port}")
        server.start()
        status, _, body, _ = app.handle(
            "GET", "/addgpu/namespace/default/pod/late/gpu/1/isEntireMount/false", b"",
            dict(AUTH_HEADER))
        assert status == 200, body
        assert app.fleet.collect_once()["nodes"][cluster.node_name]["mode"] == "rpc"
    finally:
        app.close()
        if server is not None:
            server.stop(None).wait()
        cluster.stop()


def test_an_unparseable_payload_is_scraped_as_a_worker_without_the_rpc(ops_port):
    cfg, port = ops_port
    answers = {"127.0.0.1": api.CollectTelemetryResponse(telemetry="{broken")}
    collector = fleet.FleetCollector(_Workers({"n1": "127.0.0.1"}), _stub_client(answers),
                                     cfg=dataclasses.replace(cfg, metrics_port=port))
    assert collector.collect_once()["nodes"]["n1"]["mode"] == "scrape"


@pytest.mark.parametrize("quarantined", [False, True])
def test_the_collect_telemetry_messages_are_the_references_bytes(quarantined):
    tc = "0123456789abcdef0123456789abcdef-0123456789abcdef"
    req = api.CollectTelemetryRequest(trace_context=tc, quarantined=quarantined)
    ref_req = ref_api.CollectTelemetryRequest(trace_context=tc, quarantined=quarantined)
    assert req.encode() == ref_req.encode()
    assert api.CollectTelemetryRequest.decode(ref_req.encode()).quarantined is quarantined
    body = json.dumps({"schema": "tpumounter-telemetry/1", "quarantined": quarantined})
    resp = api.CollectTelemetryResponse(node_name="gpu-node-0", telemetry=body)
    ref_resp = ref_api.CollectTelemetryResponse(collect_telemetry_result=0,
                                                node_name="gpu-node-0", telemetry=body)
    assert resp.encode() == ref_resp.encode()
    assert ref_api.CollectTelemetryResponse.decode(resp.encode()).telemetry == body
    assert api.CollectTelemetryRequest().encode() == ref_api.CollectTelemetryRequest().encode()


def test_quarantined_drains_the_warm_pool_and_lets_it_refill(tmp_path):
    """The first caller of ``WarmPodPool.set_drained``: a quarantined pull
    releases the node's holders and pauses the refill; the next pull, not
    quarantined, lets it restock; a toggle that fails leaves the answer."""
    from gpumounter_tpu_torch.testing.cluster import FakeCluster
    cluster = FakeCluster.with_fake_gpus(str(tmp_path / "c"), 4)
    cluster.cfg = dataclasses.replace(cluster.cfg, warm_pool_size=2,
                                      node_name=cluster.node_name)
    service = cluster.service(str(tmp_path / "dev"))
    pool, node = service.pool, cluster.node_name
    try:
        pool.refill_async = False
        pool.ensure_node(node)
        pool.refill_once()
        assert pool.ready_count(node) == 2
        resp = service.collect_telemetry(api.CollectTelemetryRequest(quarantined=True))
        assert fleet.parse_telemetry(resp.telemetry) is not None and resp.node_name == node
        assert pool.drained(node) and pool.ready_count(node) == 0
        # the pull's capacity section: the node's GPUs by index, read after
        # the drain released both warm holders
        section = json.loads(resp.telemetry)["capacity"]
        assert {k: section[k] for k in ("schema", "total", "free", "warm", "fenced", "held",
                                        "warm_ready", "ownership_known")} == {
            "schema": "tpumounter-capacity/1", "total": 4, "free": [0, 1, 2, 3], "warm": [],
            "fenced": [], "held": {}, "warm_ready": 0, "ownership_known": True}
        assert pool.refill_once() == 0
        service.collect_telemetry(api.CollectTelemetryRequest(quarantined=False))
        assert not pool.drained(node) and pool.refill_once() == 2
        resp = service.collect_telemetry(api.CollectTelemetryRequest(quarantined=False))
        section = json.loads(resp.telemetry)["capacity"]
        assert (len(section["warm"]), len(section["free"]), section["warm_ready"]) == (2, 2, 2)
        pool.set_drained = lambda *a: (_ for _ in ()).throw(RuntimeError("toggle broke"))
        resp = service.collect_telemetry(api.CollectTelemetryRequest(quarantined=True))
        assert fleet.parse_telemetry(resp.telemetry)["schema"] == "tpumounter-telemetry/1"
    finally:
        pool.stop()
        cluster.stop()


def test_fleet_check_on_the_cpu():
    """``entry.fleet_check`` as phase 17 runs it, on a fake host of 2 GPUs
    over the worker's gRPC server and its ops port, with a tenant that
    publishes 3 steps while the first add's GPU is mounted."""
    from gpumounter_tpu_torch import entry
    from gpumounter_tpu_torch.torchside.telemetry import TenantTelemetry

    def tenant(uuids, dev_dir, url, token):
        tel = TenantTelemetry("default/cpu-tenant", pod="cpu-tenant", token=token)
        for _ in range(3):
            with tel.step(tokens=8.0):
                pass
        assert tel.publish(url)
        return {"tenant": tel.tenant, "steps": 3}

    report = entry.fleet_check("cpu", repeats=2, on_mounted=tenant)
    flows = report["fake"]
    assert report["live"] is None and len(flows["trace_ids"]) == 2
    assert flows["node"]["mode"] == "rpc" and flows["exemplar"] in flows["trace_ids"]
    assert flows["tenant_seen"]["steps"] == 3 and flows["trace"]["remote_spans"] > 0
    assert {"mknod", "worker", "rpc", "edge"} <= set(flows["trace"]["phases"])
    assert set(flows["scopes"]["no_token"].values()) == {401}
    assert flows["scrape"]["mode"] == "scrape" and flows["scrape"]["spans"] == 0
    assert len(flows["costs"]["payload_bytes"]) == 2 and min(flows["costs"]["payload_bytes"]) > 0
