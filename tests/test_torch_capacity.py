"""The capacity plane (``gpumounter_tpu_torch/obs/capacity.py``) against the
reference's (``gpumounter_tpu/obs/capacity.py``): ``tests/test_capacity.py``
ported; its two CLI cases run on the port's CLI in ``tests/test_torch_cli.py``.

Both planes run on the same node entries and their payloads, counters and
records are compared. The one difference is the NVSwitch block: a host's
largest block is all its free GPUs, so its fragmentation index is 0 where
the reference's ICI grid may leave free chips apart
(``test_largest_block_is_the_nvswitch_block_where_the_reference_walks_the_grid``),
and the feasibility table holds ``topology.FEASIBILITY_SHAPES``, compared
with the reference's shapes of the same hosts and GPUs a host. The worker
half and the routes run on the port's fake cluster, through the master over
HTTP and gRPC.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import random
import secrets
import time

import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.config import config as ref_config
from gpumounter_tpu.master import topology as ref_topology
from gpumounter_tpu.obs import capacity as ref_capacity
from gpumounter_tpu_torch import topology
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.obs import capacity

SIDES = {"reference": (ref_capacity, RefConfig), "port": (capacity, Config)}

#: the port's config keys of the plane and of the shares, with the
#: reference's defaults and environment names
CONFIG_KEYS = {
    "capacity_blocking_hosts_max": ("CAPACITY_BLOCKING_HOSTS_MAX", 8),
    "capacity_tight_free_ratio": ("CAPACITY_TIGHT_FREE_RATIO", 0.1),
    "capacity_trend_samples": ("CAPACITY_TREND_SAMPLES", 64),
    "vchip_enabled": ("TPUMOUNTER_VCHIP", True),
    "vchip_weight_capacity": ("VCHIP_WEIGHT_CAPACITY", 100),
    "vchip_max_shares": ("VCHIP_MAX_SHARES", 1024),
    "vchip_rate_budget": ("VCHIP_RATE_BUDGET", 0),
}


@pytest.mark.parametrize("key", list(CONFIG_KEYS))
def test_the_config_keys_are_the_references(key, monkeypatch):
    env, default = CONFIG_KEYS[key]
    assert getattr(Config(), key) == getattr(RefConfig(), key) == default
    raw = "false" if isinstance(default, bool) else "3"
    monkeypatch.setenv(env, raw)
    assert getattr(Config(), key) == getattr(ref_config.Config(), key) != default


# --- one host's view ---


def test_largest_block_is_the_nvswitch_block_where_the_reference_walks_the_grid():
    """NVSwitch joins every pair of a host's GPUs: the port's block is every
    free GPU. On free {0, 3, 5, 6} of an 8-GPU host the reference's 2-wide
    grid gives a largest block of 2, the port's is 4, and the port's index
    is 0. On every subset of an 8-GPU host, and random ones of 16, the
    port's block is the free count and never under the reference's."""
    scattered = [0, 3, 5, 6]
    assert ref_capacity.largest_ici_block(scattered) == 2
    assert capacity.largest_block(scattered) == 4
    snap = _snap(scattered)
    assert ref_capacity.host_capacity(snap)["fragmentation_index"] == 0.5
    entry = capacity.host_capacity(snap)
    assert entry["fragmentation_index"] == 0.0
    assert entry["admissible_block_sizes"] == [1, 2, 4]
    for r in range(9):
        for combo in itertools.combinations(range(8), r):
            free = list(combo)
            assert capacity.largest_block(free) == len(free) >= \
                ref_capacity.largest_ici_block(free), free
    rng = random.Random(7)
    for _ in range(200):
        free = rng.sample(range(16), rng.randint(0, 12))
        assert capacity.largest_block(free) == len(free), free


def _snap(free, warm=(), fenced=(), held=None, total=8):
    return {"schema": capacity.CAPACITY_SCHEMA, "total": total, "free": sorted(free),
            "warm": sorted(warm), "fenced": sorted(fenced), "held": held or {},
            "warm_ready": len(warm), "ownership_known": True}


#: free sets that are one ICI block of an 8-chip host, where the two views
#: agree but for the reference's best_block
CONNECTED = ([0, 1, 2, 3], [0, 1], [4, 5, 6, 7], list(range(8)), [2], [])


@pytest.mark.parametrize("free", CONNECTED, ids=str)
def test_host_capacity_is_the_references_where_the_free_gpus_are_one_ici_block(free):
    assert capacity.CAPACITY_SCHEMA == ref_capacity.CAPACITY_SCHEMA
    snap = _snap(free, warm=[7] if 7 not in free else [], fenced=[],
                 held={"6": "d/p"} if 6 not in free else None)
    ref = ref_capacity.host_capacity(snap)
    ref.pop("best_block", None)
    assert capacity.host_capacity(snap) == ref
    assert capacity.host_capacity(None) == ref_capacity.host_capacity(None) == \
        {"capacity_unknown": True}


def test_host_capacity_names_no_best_block():
    """The reference names the chips a 4-block would take
    (``placement.best_block``); on NVSwitch no free GPU is a better pick."""
    ref = ref_capacity.host_capacity(_snap([0, 1, 2, 3]))
    assert ref["best_block"] == [0, 1, 2, 3]
    assert "best_block" not in capacity.host_capacity(_snap([0, 1, 2, 3]))
    assert capacity.HOST_BLOCK_SIZES == ref_capacity.HOST_BLOCK_SIZES == (1, 2, 4, 8)


# --- the master plane ---


class _FleetStub:
    """A ``FleetCollector`` stand-in: canned node entries."""

    def __init__(self, nodes):
        self.nodes = nodes

    def payload(self, max_age_s=None):
        return {"at": 1.0, "nodes": self.nodes}


def _plane(side, nodes, elastic=None, **cfg):
    mod, config = SIDES[side]
    conf = config().replace(**cfg) if side == "reference" else config(**cfg)
    return mod.CapacityPlane(_FleetStub(nodes), cfg=conf, elastic=elastic)


def _entry(free, warm=(), fenced=(), held=None, total=8):
    return {"capacity": _snap(free, warm, fenced, held, total)}


def _same_shape_rows(ref_table: dict, port_table: dict) -> list[tuple[str, str]]:
    """(reference type, port type) of the rows with one host count and GPUs
    a host on both sides."""
    port_by = {(r["chips_per_host"], r["hosts_needed"]): k for k, r in port_table.items()}
    return [(k, port_by[(r["chips_per_host"], r["hosts_needed"])])
            for k, r in sorted(ref_table.items())
            if (r["chips_per_host"], r["hosts_needed"]) in port_by]


def _payloads(nodes, **cfg) -> tuple[dict, dict]:
    ref, port = (_plane(side, nodes, **cfg).payload() for side in SIDES)
    for host in ref["nodes"].values():
        host.pop("best_block", None)
    return ref, port


def test_the_feasibility_shapes_are_the_h100s():
    """1, 2, 4 and 8 GPUs on one host (GKE's a3-highgpu-1g/2g/4g/8g), then
    2-32 whole hosts of 8 (16-256 GPUs), each named <type>-<n> and built by
    ``lookup``; the reference's table covers 1-256 chips as well."""
    shapes = topology.FEASIBILITY_SHAPES
    assert list(shapes) == [f"nvidia-h100-80gb-{n}" for n in (1, 2, 4, 8, 16, 32, 64, 128, 256)]
    for name, topo in shapes.items():
        assert topo == topology.lookup("nvidia-h100-80gb", topo.total_gpus)
        assert name == f"{topo.accel_type}-{topo.total_gpus}"
    assert max(t.total_chips for t in ref_topology._TOPOLOGIES.values()) == \
        max(t.total_gpus for t in shapes.values()) == 256


def test_feasibility_every_shape_admissible_when_the_fleet_is_free():
    """64 free 8-GPU hosts: every shape admissible with no blocking host,
    and tracked when the fleet could hold it; the shared rows are the
    reference's, and so are the fleet's numbers."""
    nodes = {f"n-{i}": _entry(range(8)) for i in range(64)}
    ref, port = _payloads(nodes)
    table = port["feasibility"]
    assert set(table) == set(topology.FEASIBILITY_SHAPES)
    for accel_type, topo in topology.FEASIBILITY_SHAPES.items():
        entry = table[accel_type]
        assert (entry["verdict"], entry["blocking_hosts"]) == ("admissible", [])
        assert (entry["chips_per_host"], entry["hosts_needed"], entry["total_chips"]) == \
            (topo.gpus_per_host, topo.num_hosts, topo.total_gpus)
        assert entry["tracked"] == (topo.total_gpus <= 512)
    rows = _same_shape_rows(ref["feasibility"], table)
    assert {p for _, p in rows} == {"nvidia-h100-80gb-1", "nvidia-h100-80gb-4",
                                    "nvidia-h100-80gb-8"}
    for r, p in rows:
        assert ref["feasibility"][r] == table[p], (r, p)
    assert ref["fleet"] == port["fleet"] and ref["nodes"] == port["nodes"]


#: (case, nodes, the port's row, its verdict, its blocking hosts, the
#: reference's row, its verdict)
VERDICTS = {
    # free GPUs apart on the grid: the reference waits for a defragmentation,
    # NVSwitch admits now
    "scattered free GPUs": ({f"frag-{i}": _entry([0, 3, 4, 7]) for i in range(4)},
                            "nvidia-h100-80gb-4", "admissible", [],
                            "v5litepod-16", "admissible-after-defrag"),
    # warm holders are reclaimable: both wait for a defragmentation
    "free and warm": ({"w": _entry(free=[0, 3], warm=[4, 7])},
                      "nvidia-h100-80gb-4", "admissible-after-defrag", ["w"],
                      "v5litepod-4", "admissible-after-defrag"),
    "too few GPUs": ({"only": _entry([0, 1])}, "nvidia-h100-80gb-16", "infeasible", [],
                     "v5litepod-16", "infeasible"),
}


@pytest.mark.parametrize("case", list(VERDICTS))
def test_feasibility_verdicts(case):
    nodes, row, verdict, blocking, ref_row, ref_verdict = VERDICTS[case]
    ref, port = _payloads(nodes)
    entry = port["feasibility"][row]
    assert (entry["verdict"], entry["blocking_hosts"]) == (verdict, blocking)
    assert ref["feasibility"][ref_row]["verdict"] == ref_verdict
    if case == "too few GPUs":
        assert entry["tracked"] is False and ref["feasibility"][ref_row]["tracked"] is False
    for r, p in _same_shape_rows(ref["feasibility"], port["feasibility"]):
        if case != "scattered free GPUs":
            assert ref["feasibility"][r] == port["feasibility"][p], (r, p)


def test_fleet_rollup_and_its_weighted_index():
    nodes = {"a": _entry(free=[0, 1, 2, 3]), "b": _entry(free=[0, 7]),
             "legacy": {"capacity": None}}
    ref, port = _payloads(nodes)
    fleet = port["fleet"]
    assert (fleet["hosts"], fleet["hosts_reporting"], fleet["free"]) == (3, 2, 6)
    # the reference's grid reaches 4 + 1 of 6 free chips; NVSwitch all 6
    assert ref["fleet"]["fragmentation_index"] == round(1 - 5 / 6, 4)
    assert (fleet["fragmentation_index"], fleet["largest_block"]) == (0.0, 4)
    assert port["nodes"]["legacy"] == ref["nodes"]["legacy"] == {"capacity_unknown": True}
    ref["fleet"].pop("fragmentation_index")
    assert {k: v for k, v in fleet.items() if k != "fragmentation_index"} == ref["fleet"]


def _counts(mod):
    return mod.CAPACITY_SIZE_FEASIBLE.total(), mod.CAPACITY_SIZE_INFEASIBLE.total()


def test_observe_counts_only_the_denials_a_defragmentation_would_lift():
    """A full fleet records no bad event, on both sides; on NVSwitch only
    warm holders can put a host after a defragmentation."""
    held = {str(i): "default/p" for i in range(8)}
    busy = {f"busy-{i}": {"capacity": _snap([], held=held)} for i in range(4)}
    for side in SIDES:
        mod = SIDES[side][0]
        good0, bad0 = _counts(mod)
        _plane(side, busy).observe(busy)
        good, bad = _counts(mod)
        assert bad == bad0 and good > good0, side
    scattered = {f"s-{i}": _entry([0, 3, 4, 7]) for i in range(4)}
    warm = {f"w-{i}": _entry([0, 3], warm=[4, 7]) for i in range(4)}
    for nodes, port_bad in ((scattered, False), (warm, True)):
        for side in SIDES:
            mod = SIDES[side][0]
            _, bad0 = _counts(mod)
            _plane(side, nodes).observe(nodes)
            grew = _counts(mod)[1] > bad0
            assert grew == (True if side == "reference" else port_bad), (side, nodes)
    assert capacity.CAPACITY_FREE_CHIPS.name == ref_capacity.CAPACITY_FREE_CHIPS.name


@pytest.mark.parametrize("via", ["observe", "payload"])
def test_the_host_cache_rederives_only_the_nodes_that_moved(monkeypatch, via):
    nodes = {f"n-{i}": _entry(range(8)) for i in range(4)}
    plane = _plane("port", nodes)
    getattr(plane, via)(*([nodes] if via == "observe" else []))
    calls = []
    real = capacity.host_capacity
    monkeypatch.setattr(capacity, "host_capacity",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = getattr(plane, via)(*([nodes] if via == "observe" else []))
    assert not calls
    if via == "payload":
        assert out["fleet"]["free"] == 32
        return
    changed = dict(nodes, **{"n-0": _entry(range(4))})
    plane.observe(changed)
    assert len(calls) == 1


def test_stale_nodes_never_count_as_live_capacity():
    nodes = {"live": _entry(range(8)), "dead": {**_entry(range(8)), "stale": True}}
    ref, port = _payloads(nodes)
    assert port["nodes"] == ref["nodes"]
    assert port["nodes"]["dead"] == {"capacity_unknown": True, "stale": True}
    assert (port["fleet"]["hosts_reporting"], port["fleet"]["free"]) == (1, 8)
    # two hosts of 8 are needed: the dead node must not make up the second
    entry = port["feasibility"]["nvidia-h100-80gb-16"]
    assert (entry["verdict"], entry["hosts_admissible_now"]) == ("infeasible", 1)


def _headroom(side, nodes):
    return _plane(side, nodes).payload()["headroom"]


def test_the_headroom_forecast_is_the_references():
    busy = _entry([0], held={str(i): "d/p" for i in range(1, 8)})
    busy["tenants"] = {"t1": {"at": 5.0, "queue_depth": 50, "tokens_per_s": 10.0}}
    drained = _entry([], held={str(i): "d/p" for i in range(8)})
    for nodes, forecast in (({"a": _entry(range(8))}, "ok"), ({"a": busy}, "tight"),
                            ({"a": drained}, "exhausted")):
        got = {side: _headroom(side, nodes) for side in SIDES}
        assert got["port"] == got["reference"]
        assert got["port"]["forecast"] == forecast
    assert got["port"]["trend"] == {"window_s": 0.0, "free_delta": 0, "queue_delta": 0.0}


class _Elastic:
    """The reconciler's store and status, as /capacity's demand reads them."""

    def __init__(self, intents, actual):
        self.store = self
        self._intents, self._actual = intents, actual

    def list(self):
        return self._intents

    def status_for(self, namespace, pod):
        return {"actual": self._actual.get(pod)}


def test_the_demand_is_the_references():
    from gpumounter_tpu.elastic.intents import Intent as RefIntent
    from gpumounter_tpu_torch.elastic.intents import Intent
    nodes = {"a": _entry([0, 1], warm=[2])}
    got = {}
    for side, intent in (("reference", RefIntent), ("port", Intent)):
        elastic = _Elastic([("d", "p", intent(desired_chips=4, min_chips=1)),
                            ("d", "q", intent(desired_chips=2, min_chips=1))], {"p": 1})
        got[side] = _plane(side, nodes, elastic=elastic).payload()["demand"]
    assert got["port"] == got["reference"] == {"intents": 2, "desired_chips": 6,
                                               "actual_chips": 1, "gap": 5,
                                               "satisfiable": False}


def test_a_rejection_lands_in_the_audit_trail_and_on_the_timeline():
    """``capacity.reject``: the reference's verdict and outcome, but the
    cause, which on NVSwitch is exhaustion whenever the host's free GPUs
    fall short, and never fragmentation."""
    from gpumounter_tpu.obs.audit import AUDIT as REF_AUDIT
    from gpumounter_tpu_torch.obs.audit import AUDIT
    from gpumounter_tpu_torch.obs.flight import FLIGHT, install
    install()
    nodes = {"n-0": _entry([0, 1, 2, 3])}  # one ICI block of 4 on both sides
    verdicts = {side: _plane(side, nodes).record_rejection("n-0", "default", "victim", 6)
                for side in SIDES}
    assert verdicts["port"] == verdicts["reference"]
    assert verdicts["port"]["cause"] == "exhaustion"
    rec = AUDIT.query(operation="capacity.reject")[0]
    ref = [r for r in REF_AUDIT.snapshot() if r["operation"] == "capacity.reject"][-1]
    keys = ("operation", "actor", "namespace", "pod", "outcome", "details")
    assert {k: rec[k] for k in keys} == {k: ref[k] for k in keys}
    assert "want 6 chip(s)" in rec["outcome"] and rec["details"]["node"] == "n-0"
    assert any(r["kind"] == "audit" and "capacity.reject" in r["summary"]
               for r in FLIGHT.snapshot())
    scattered = {"n-0": _entry([0, 3, 4, 7])}
    assert _plane("reference", scattered).record_rejection(
        "n-0", "d", "v", 4)["cause"] == "fragmentation"
    assert _plane("port", scattered).record_rejection("n-0", "d", "v", 4)["cause"] == \
        "exhaustion"
    unknown = _plane("port", {}).record_rejection("gone", "d", "v", 1)
    assert unknown == _plane("reference", {}).record_rejection("gone", "d", "v", 1)
    assert unknown["node_view"] == "unknown"


def test_a_recovery_stamp_is_the_references():
    from gpumounter_tpu.obs.audit import AUDIT as REF_AUDIT
    from gpumounter_tpu_torch.obs.audit import AUDIT
    nodes = {"n-0": _entry(range(8))}
    kw = dict(cause="fragmentation", plan_id="plan-1", fragmentation_before=0.5,
              fragmentation_after=0.0, moves=2)
    got = {side: _plane(side, nodes).record_recovery(**kw) for side in SIDES}
    assert got["port"] == got["reference"]
    rec = AUDIT.query(operation="capacity.recovered")[0]
    ref = [r for r in REF_AUDIT.snapshot() if r["operation"] == "capacity.recovered"][-1]
    assert (rec["outcome"], rec["details"]) == (ref["outcome"], ref["details"])


def test_the_module_level_stamps_do_nothing_without_a_plane():
    from gpumounter_tpu_torch.obs.audit import AUDIT
    capacity.register_plane(None)
    try:
        assert capacity.record_rejection("n", "ns", "p", 1) is None
        assert capacity.blocked_hosts() == frozenset()
        assert AUDIT.query(operation="capacity.reject") == []
        plane = _plane("port", {"n": _entry([0, 1], warm=[2, 3])})
        capacity.register_plane(plane)
        assert capacity.record_rejection("n", "ns", "p", 1) is None
        assert len(AUDIT.query(operation="capacity.reject")) == 1
        assert capacity.blocked_hosts() == frozenset({"n"})
    finally:
        capacity.register_plane(None)


def test_the_default_objectives_hold_slice_feasibility():
    from gpumounter_tpu.obs.slo import DEFAULT_OBJECTIVES as REF_DEFAULTS
    from gpumounter_tpu_torch.obs.slo import DEFAULT_OBJECTIVES
    ours = {o.name: dataclasses.asdict(o) for o in DEFAULT_OBJECTIVES}
    theirs = {o.name: dataclasses.asdict(o) for o in REF_DEFAULTS}
    assert ours["slice-feasibility"] == theirs["slice-feasibility"]
    assert (ours["slice-feasibility"]["kind"], ours["slice-feasibility"]["good"],
            ours["slice-feasibility"]["bad"]) == ("ratio", "slice_feasible", "slice_infeasible")


def test_set_attrs_lands_on_the_innermost_open_span():
    from gpumounter_tpu_torch.obs import trace
    tracer = trace.Tracer(ring_capacity=16)
    with trace.span("outer", tracer=tracer):
        with trace.span("inner", tracer=tracer, fixed="x"):
            trace.set_attrs(late=1)
        trace.set_attrs(outer_late=2)
    spans = {s["name"]: s for s in tracer.ring.snapshot()}
    assert spans["inner"]["attrs"] == {"fixed": "x", "late": 1}
    assert spans["outer"]["attrs"] == {"outer_late": 2}
    trace.set_attrs(ignored=True)


# --- the worker half, on the port's fake cluster ---


def _fake_cluster(tmp_path, **cfg):
    from gpumounter_tpu_torch.testing.cluster import FakeCluster
    return FakeCluster.with_fake_gpus(str(tmp_path / "fake"), 4,
                                      cfg=Config(node_name="gpu-node-0", **cfg))


def _collector(cluster):
    from gpumounter_tpu_torch.collector.collector import GpuCollector
    return GpuCollector(cluster.backend, cluster.kubelet, cfg=cluster.cfg)


def _bound(cluster, namespace: str, name: str, timeout_s: float = 5.0) -> list[str]:
    """The GPUs the scheduler bound to the pod, waited for with a deadline:
    a snapshot taken before the binding would read the GPU free."""
    deadline = time.monotonic() + timeout_s
    while True:
        with cluster._alloc_lock:
            bound = [u for u, owner in cluster.node().assignment.items()
                     if owner == (namespace, name)]
        if bound or time.monotonic() > deadline:
            return bound
        time.sleep(0.01)


def test_node_capacity_snapshot_classification(tmp_path):
    cluster = _fake_cluster(tmp_path)
    collector = _collector(cluster)
    cluster.kube.create_pod("default", {
        "metadata": {"name": "holder", "namespace": "default"},
        "spec": {"containers": [{"name": "m", "resources": {
            "limits": {cluster.cfg.gpu_resource_name: "1"}}}]}})
    assert len(_bound(cluster, "default", "holder")) == 1
    cluster.kill_gpu(3)
    snap = capacity.node_capacity_snapshot(collector, cfg=cluster.cfg)
    assert (snap["schema"], snap["total"], snap["fenced"], snap["warm"]) == \
        (capacity.CAPACITY_SCHEMA, 4, [3], [])
    held = sorted(int(i) for i in snap["held"])
    assert len(held) == 1 and snap["held"][str(held[0])] == "default/holder"
    assert set(snap["free"]) == {0, 1, 2} - set(held)
    assert snap["ownership_known"] is True
    assert set(snap) == {"schema", "total", "free", "warm", "fenced", "held", "warm_ready",
                         "ownership_known"}


def test_a_kubelet_that_fails_the_refresh_keeps_the_marks_and_flips_ownership(tmp_path):
    cluster = _fake_cluster(tmp_path)
    collector = _collector(cluster)
    capacity.node_capacity_snapshot(collector, cfg=cluster.cfg)

    def broken():
        raise OSError("kubelet down")

    collector.update_status = broken
    snap = capacity.node_capacity_snapshot(collector, cfg=cluster.cfg)
    assert snap["ownership_known"] is False and snap["free"] == [0, 1, 2, 3]


def test_warm_holders_read_warm_and_the_gauge_agrees(tmp_path):
    from gpumounter_tpu_torch.allocator.pool import WarmPodPool
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    cluster = _fake_cluster(tmp_path, warm_pool_size=2)
    pool = WarmPodPool(cluster.kube, cfg=cluster.cfg, refill_async=False)
    pool.refill_once()
    assert pool.ready_count(cluster.node_name) == 2
    snap = capacity.node_capacity_snapshot(_collector(cluster), pool=pool, cfg=cluster.cfg)
    assert (len(snap["warm"]), snap["warm_ready"], len(snap["free"]), snap["held"]) == \
        (2, 2, 2, {})
    assert REGISTRY.find("tpumounter_warm_pool_ready").get(node=cluster.node_name) == 2.0
    fresh = WarmPodPool(cluster.kube, cfg=cluster.cfg, refill_async=False)
    fresh.ensure_node("fresh-node")
    assert REGISTRY.find("tpumounter_warm_pool_ready").get(node="fresh-node") == 0.0


def _ref_cluster(root):
    from gpumounter_tpu.collector.collector import TpuCollector
    from gpumounter_tpu.collector.podresources import PodResourcesClient
    from gpumounter_tpu.testing.cluster import FakeCluster as RefCluster
    cluster = RefCluster(str(root), n_chips=4).start()
    cfg = cluster.cfg.replace(node_name=cluster.node_name)
    collector = TpuCollector(backend=cluster.backend, podresources=PodResourcesClient(
        cfg.kubelet_socket, timeout_s=5.0), cfg=cfg)
    return cluster, cfg, collector


def _held_and_dead(side, root):
    """One GPU held by a pod the scheduler bound, the last one dead."""
    if side == "reference":
        cluster, cfg, collector = _ref_cluster(root)
        resource, kill = cfg.tpu_resource_name, cluster.kill_chip
    else:
        cluster = _fake_cluster(root)
        cfg, collector = cluster.cfg, _collector(cluster)
        resource, kill = cfg.gpu_resource_name, cluster.kill_gpu
    try:
        cluster.kube.create_pod("default", {
            "metadata": {"name": "holder", "namespace": "default"},
            "spec": {"containers": [{"name": "m", "resources": {"limits": {resource: "1"}}}]}})
        assert len(_bound(cluster, "default", "holder")) == 1
        kill(3)
        return SIDES[side][0].node_capacity_snapshot(collector, cfg=cfg)
    finally:
        if side == "reference":
            cluster.stop()


def _warm_holders(side, root):
    """Two warm holders from the pool's refill, read through its book."""
    if side == "reference":
        from gpumounter_tpu.allocator.pool import WarmPodPool as RefPool
        cluster, cfg, collector = _ref_cluster(root)
        cfg = cfg.replace(warm_pool_size=2)
        pool = RefPool(cluster.kube, cfg=cfg, refill_async=False)
    else:
        from gpumounter_tpu_torch.allocator.pool import WarmPodPool
        cluster = _fake_cluster(root, warm_pool_size=2)
        cfg, collector = cluster.cfg, _collector(cluster)
        pool = WarmPodPool(cluster.kube, cfg=cfg, refill_async=False)
    try:
        pool.refill_once()
        return SIDES[side][0].node_capacity_snapshot(collector, pool=pool, cfg=cfg)
    finally:
        if side == "reference":
            cluster.stop()


@pytest.mark.parametrize("scenario", [_held_and_dead, _warm_holders],
                         ids=lambda f: f.__name__.strip("_"))
def test_the_worker_snapshot_is_the_references(scenario, tmp_path):
    """``node_capacity_snapshot`` on the reference's fake cluster of 4 chips
    and on the port's of 4 GPUs in one scenario: the same section, whose
    indices are each inventory's order on both sides."""
    ref, port = (scenario(side, tmp_path / side) for side in SIDES)
    assert port == ref
    assert (port["held"], port["fenced"]) == ({"0": "default/holder"}, [3]) \
        if scenario is _held_and_dead else (len(port["warm"]), port["warm_ready"]) == (2, 2)


# --- the routes on the master, against the reference's ---


#: node entries whose free GPUs are one ICI block on the reference's grid,
#: so its views and NVSwitch's agree: a free host, one with warm, held and
#: fenced GPUs, and one whose worker sent no capacity section
ROUTE_NODES = {"a": _entry(free=[0, 1, 2, 3]),
               "b": _entry(free=[0, 1], warm=[2, 3], held={"4": "default/x"}, fenced=[7]),
               "legacy": {"capacity": None}}

#: the share requests of the route test, in order: two tenants, a re-grant
#: on a tenant's own GPU (refused: the packer passes over it), a weight
#: past the capacity
SHARE_REQUESTS = [
    {"namespace": "default", "pod": "t1", "profile": "decode", "chips": 1, "weight": 40,
     "rate_budget": 64, "inventory": {"u-0": "a", "u-1": "a"}},
    {"namespace": "default", "pod": "t2", "profile": "prefill", "chips": 1, "weight": 50,
     "inventory": {"u-1": "a"}},
    {"namespace": "default", "pod": "t1", "profile": "decode", "chips": 1, "weight": 60,
     "rate_budget": 64, "inventory": {"u-0": "a"}},
    {"namespace": "default", "pod": "t3", "profile": "decode", "chips": 1, "weight": 101},
]


def _route_apps():
    """The reference's MasterApp and the port's over their fake API servers,
    each plane over ROUTE_NODES; yields {side: handle(method, path, body)}."""
    from gpumounter_tpu.k8s.fake import FakeKubeClient as RefKube
    from gpumounter_tpu.master import app as ref_app
    from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
    from gpumounter_tpu_torch.master.app import MasterApp
    token = secrets.token_hex(8)
    apps = {"reference": ref_app.MasterApp(RefKube(), cfg=RefConfig(auth_token=token)),
            "port": MasterApp(FakeKubeClient(), cfg=Config(auth_token=token))}

    def handler(app):
        def handle(method, path, body=None):
            status, _, text, _ = app.handle(method, path, json.dumps(body).encode()
                                            if body is not None else b"",
                                            {"Authorization": f"Bearer {token}"})
            return status, text
        return handle

    for app in apps.values():
        app.capacity.fleet = _FleetStub(ROUTE_NODES)
    return apps, {side: handler(app) for side, app in apps.items()}


def _undated(payload):
    """A route's JSON without its clocks ("at", each share's "created_at")
    and the reference's ``best_block``."""
    if isinstance(payload, dict):
        return {k: _undated(v) for k, v in payload.items()
                if k not in ("at", "created_at", "best_block")}
    if isinstance(payload, list):
        return [_undated(v) for v in payload]
    return payload


def test_the_capacity_and_shares_routes_are_the_references():
    """GET /capacity (whole, filtered, an unknown type), POST /shares (two
    tenants on one GPU, a re-grant and an overweight request refused),
    GET /shares and DELETE /shares/<ns>/<pod> (and again: 404) on the
    reference's master and the port's: the same codes, and the same
    payloads but the feasibility table's names, whose rows of one shape
    agree."""
    ref_plane = ref_capacity._PLANE
    apps, handle = _route_apps()
    try:
        ref, port = (json.loads(handle[side]("GET", "/capacity")[1]) for side in SIDES)
        ref, port = _undated(ref), _undated(port)
        rows = _same_shape_rows(ref.pop("feasibility"), port.pop("feasibility"))
        assert rows and port == ref
        for ref_row, port_row in rows:
            tables = [handle[side]("GET", f"/capacity?accel_type={row}")
                      for side, row in zip(SIDES, (ref_row, port_row))]
            assert [status for status, _ in tables] == [200, 200]
            (ref_row_seen, ref_entry), = json.loads(tables[0][1])["feasibility"].items()
            (port_row_seen, port_entry), = json.loads(tables[1][1])["feasibility"].items()
            assert (ref_row_seen, port_row_seen) == (ref_row, port_row)
            assert ref_entry == port_entry, (ref_row, port_row)
        assert [handle[side]("GET", "/capacity?accel_type=bogus-9000")[0] for side in SIDES] \
            == [404, 404]
        for request in SHARE_REQUESTS:
            answers = [handle[side]("POST", "/shares", request) for side in SIDES]
            assert answers[0][0] == answers[1][0], request
            if answers[0][0] == 200:
                assert _undated(json.loads(answers[0][1])) == _undated(json.loads(answers[1][1]))
        assert [a[0] for a in (handle["port"]("POST", "/shares", r) for r in SHARE_REQUESTS[2:])] \
            == [409, 409]
        shares = [_undated(json.loads(handle[side]("GET", "/shares")[1])) for side in SIDES]
        assert shares[0] == shares[1] and shares[1]["totals"] == \
            {"shares": 2, "chips": 1, "shared_chips": 1}
        views = [_undated(json.loads(handle[side]("GET", "/capacity")[1]))["shares"]
                 for side in SIDES]
        assert views[0] == views[1]
        released = [handle[side]("DELETE", "/shares/default/t1") for side in SIDES]
        assert [r[0] for r in released] == [200, 200]
        assert _undated(json.loads(released[0][1])) == _undated(json.loads(released[1][1]))
        assert [handle[side]("DELETE", "/shares/default/t1")[0] for side in SIDES] == [404, 404]
    finally:
        apps["port"].close()
        ref_capacity.register_plane(ref_plane)


# --- the routes, through the master over HTTP and gRPC ---


@pytest.fixture
def stack(tmp_path):
    """The master's HTTP API before one worker over gRPC, on a fake host of 4
    GPUs with a warm pool of 1: the smallest stack where /capacity, the
    warm classification and the slave pods' span are all real."""
    from gpumounter_tpu_torch.entry import _MasterStack
    cluster = _fake_cluster(tmp_path, auth_mode="token", auth_token=secrets.token_hex(16),
                            warm_pool_size=1, fleet_scrape_interval_s=3600.0)
    dev_dir = str(tmp_path / "tenant-dev")
    os.makedirs(dev_dir)
    with _MasterStack(cluster, {cluster.node_name: dev_dir}) as s:
        pool = s.services[cluster.node_name].pool
        assert pool.wait_ready(cluster.node_name, 1, timeout_s=10.0)
        yield s


def test_the_capacity_route_payload_filter_and_scope(stack):
    status, body, _ = stack.http("GET", "/capacity")
    assert status == 200
    payload = json.loads(body)
    node = payload["nodes"][stack.cluster.node_name]
    assert (node["total"], node["warm"], node["free"], node["fragmentation_index"]) == \
        (4, 1, 3, 0.0)
    assert payload["fleet"]["warm"] == 1
    assert payload["feasibility"]["nvidia-h100-80gb-1"]["verdict"] == "admissible"
    assert payload["headroom"]["forecast"] == "ok"
    assert set(payload) == {"at", "nodes", "fleet", "feasibility", "headroom", "demand",
                            "shares"}
    assert stack.http("GET", "/capacity", token=None)[0] == 401
    status, body, _ = stack.http("GET", "/capacity?accel_type=nvidia-h100-80gb-4")
    assert status == 200 and list(json.loads(body)["feasibility"]) == ["nvidia-h100-80gb-4"]
    assert stack.http("GET", "/capacity?accel_type=bogus-9000")[0] == 404


def test_an_insufficient_add_stamps_the_capacity_verdict(stack):
    from gpumounter_tpu_torch.obs.audit import AUDIT
    stack.cluster.add_target_pod("greedy")
    status, _, _ = stack.http("GET", "/addgpu/namespace/default/pod/greedy/gpu/5"
                                     "/isEntireMount/false")
    assert status == 500
    rejections = AUDIT.query(operation="capacity.reject")
    assert len(rejections) == 1 and rejections[0]["pod"] == "greedy"
    assert "want 5 chip(s)" in rejections[0]["outcome"]


def test_the_slave_pods_span_carries_the_pools_outcome(stack):
    """A 2-GPU add against a pool of 1: one warm holder adopted, one cold;
    the owner's node is not blocked."""
    from gpumounter_tpu_torch.obs import trace
    stack.cluster.add_target_pod("spanpod")
    status, _, _ = stack.http("GET", "/addgpu/namespace/default/pod/spanpod/gpu/2"
                                     "/isEntireMount/false")
    assert status == 200
    spans = [s for s in trace.TRACER.ring.snapshot()
             if s.get("name") == "mount.slave_pod_schedule"]
    attrs = spans[-1].get("attrs") or {}
    assert (attrs.get("pool_enabled"), attrs.get("pool_hit"), attrs.get("pool_gap")) == \
        (True, 1, 1)


def test_capacity_share_check_on_the_cpu():
    """``entry.capacity_share_check("cpu")`` as phase 20 runs it, on a fake
    host of 1 GPU through the master and the worker over gRPC."""
    from gpumounter_tpu_torch.entry import SHARE, SHARE_REGRANT_WEIGHT, capacity_share_check
    seen = []
    report = capacity_share_check("cpu", on_mounted=lambda uuids, dev_dir: seen.append(uuids)
                                  or {"uuids": uuids})
    f = report["fake"]
    assert report["live"] is None and f["inventory"]["free"] == [0] == f["freed"]
    uuid = seen[0][0]
    want = [SHARE["weight"], SHARE["rate_budget"]]
    assert f["ledgers"] == {"books": {uuid: want}, "ledger": {uuid: want}, "engine": {uuid: want}}
    # a re-grant is books-only, as the reference's: the worker keeps the
    # first weight until the release clears all three
    assert f["regrant"] == {"books": {uuid: [SHARE_REGRANT_WEIGHT, SHARE["rate_budget"]]},
                            "ledger": {uuid: want}, "engine": {uuid: want}}
    assert f["throttle"] == [True, True, True, False, False]
    assert f["held"]["forecast"] == "exhausted" and f["held"]["slice_feasible"] >= 1
    assert f["rejection"]["cause"] == "exhaustion" and f["tenant"] == {"uuids": [uuid]}


def test_a_closed_master_unregisters_its_plane():
    """A master registers its plane at construction (the newest wins) and
    unregisters it on close, unless a newer master's took its place."""
    from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
    from gpumounter_tpu_torch.master.app import MasterApp
    first = MasterApp(FakeKubeClient(), cfg=Config())
    assert capacity._PLANE is first.capacity
    second = MasterApp(FakeKubeClient(), cfg=Config())
    first.close()
    assert capacity._PLANE is second.capacity
    second.close()
    assert capacity._PLANE is None
