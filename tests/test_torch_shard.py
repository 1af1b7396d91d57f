"""The port's sharded masters (``gpumounter_tpu_torch/master/shard.py``).

Held to ``tests/test_shard.py`` (the two cases of the reconciler and the
migration machine wait for those packages), the shard cases of
``tests/test_fencing.py`` and the lease cases of ``tests/test_api_outage.py``:
every case runs on both packages (their ``FakeKubeClient``, ``Config``,
failpoints and ``ShardManager``) with the reference's expectations. The
ring's node -> shard mapping is compared name for name: it is a contract
between replicas of mixed versions.
"""

from __future__ import annotations

import dataclasses
import time
import types

import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.faults import failpoints as ref_failpoints
from gpumounter_tpu.k8s import errors as ref_errors
from gpumounter_tpu.k8s.fake import FakeKubeClient as RefFake
from gpumounter_tpu.master import shard as ref_shard
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.k8s import errors
from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
from gpumounter_tpu_torch.master import shard

SIDES = {
    "reference": types.SimpleNamespace(
        shard=ref_shard, Fake=RefFake, failpoints=ref_failpoints, errors=ref_errors,
        cfg=lambda **kw: RefConfig().replace(**kw)),
    "port": types.SimpleNamespace(
        shard=shard, Fake=FakeKubeClient, failpoints=failpoints, errors=errors,
        cfg=lambda **kw: dataclasses.replace(Config(), **kw)),
}


@pytest.fixture(params=list(SIDES))
def side(request):
    yield SIDES[request.param]
    SIDES[request.param].failpoints.disarm_all()


def _cfg(side, **kw):
    base = {"shard_count": 3, "shard_lease_duration_s": 5.0, "shard_preferred": ""}
    base.update(kw)
    return side.cfg(**base)


def _manager(side, kube, cfg, rid, preferred=None, url=None):
    return side.shard.ShardManager(kube, cfg=cfg, replica_id=rid,
                                   advertise_url=url or f"http://{rid}", preferred=preferred)


# --- the ring ---

@pytest.mark.parametrize("count", [1, 2, 3, 5, 16])
def test_the_ring_maps_node_names_to_the_references_shards(count):
    names = ([f"node-{i}" for i in range(500)] + [f"gke-tpu-node-{i}" for i in range(200)]
             + ["gpu-node-0", "storm-node-7", "", "a" * 300, "ノード"])
    ring, ref_ring = shard.HashRing(count), ref_shard.HashRing(count)
    assert [ring.owner_of(n) for n in names] == [ref_ring.owner_of(n) for n in names]
    assert shard.LEASE_PREFIX == ref_shard.LEASE_PREFIX == "tpumounter-shard"


def test_ring_total_and_deterministic(side):
    ring_a, ring_b = side.shard.HashRing(4), side.shard.HashRing(4)
    for i in range(500):
        owner = ring_a.owner_of(f"node-{i}")
        assert 0 <= owner < 4 and owner == ring_b.owner_of(f"node-{i}")


def test_ring_reasonably_balanced(side):
    ring, counts = side.shard.HashRing(3), [0, 0, 0]
    for i in range(1200):
        counts[ring.owner_of(f"gke-tpu-node-{i}")] += 1
    assert min(counts) > 1200 / 3 / 2, counts


def test_ring_growth_remaps_a_minority(side):
    before, after = side.shard.HashRing(3), side.shard.HashRing(4)
    moved = sum(1 for i in range(1000)
                if before.owner_of(f"node-{i}") != after.owner_of(f"node-{i}"))
    assert moved < 500, moved


def test_single_shard_ring_is_constant(side):
    ring = side.shard.HashRing(1)
    assert {ring.owner_of(f"n{i}") for i in range(50)} == {0}


# --- preferences, the inactive manager ---

def test_preferred_auto_uses_statefulset_ordinal(side):
    kube = side.Fake()
    m = side.shard.ShardManager(kube, cfg=_cfg(side, shard_preferred="auto"),
                                replica_id="gpu-mounter-master-2")
    assert m.preferred == {2}
    m = side.shard.ShardManager(kube, cfg=_cfg(side, shard_preferred="auto"),
                                replica_id="no-ordinal-name")
    assert m.preferred is None


def test_preferred_explicit_list(side):
    m = side.shard.ShardManager(side.Fake(), cfg=_cfg(side, shard_preferred="0, 2"),
                                replica_id="x")
    assert m.preferred == {0, 2}


def test_inactive_manager_owns_everything(side):
    m = _manager(side, side.Fake(), _cfg(side), "solo")
    assert not m.active() and m.owns_node("any-node")
    assert m.route("any-node") == ("local", None)


def test_the_replica_id_comes_from_the_environment(monkeypatch):
    """TPUMOUNTER_REPLICA_ID, else HOSTNAME, is read by config, as the
    reference's."""
    monkeypatch.delenv("TPUMOUNTER_REPLICA_ID", raising=False)
    monkeypatch.setenv("HOSTNAME", "gpu-mounter-master-1")
    assert Config().replica_id == RefConfig().replica_id == "gpu-mounter-master-1"
    monkeypatch.setenv("TPUMOUNTER_REPLICA_ID", "rep-x")
    assert Config().replica_id == RefConfig().replica_id == "rep-x"
    assert shard.ShardManager(FakeKubeClient(), cfg=Config()).replica_id == "rep-x"


# --- the lease's life ---

def test_acquire_renew_and_peer_routing(side):
    kube, cfg = side.Fake(), _cfg(side, shard_count=2)
    a = _manager(side, kube, cfg, "m-0", preferred={0}).start_without_loop()
    b = _manager(side, kube, cfg, "m-1", preferred={1}).start_without_loop()
    assert a.acquire_once() == {0} and b.acquire_once() == {1}
    assert a.acquire_once() == set() and b.acquire_once() == set()
    assert a.owned_shards() == {0} and b.owned_shards() == {1}
    remote = [f"n-{i}" for i in range(64) if a.owner_shard(f"n-{i}") == 1]
    assert a.route(remote[0]) == ("remote", "http://m-1")
    assert not a.owns_node(remote[0]) and b.owns_node(remote[0])


def test_fresh_lease_respects_preference_but_expiry_does_not(side):
    kube, cfg = side.Fake(), _cfg(side, shard_count=2, shard_lease_duration_s=0.2)
    picky = _manager(side, kube, cfg, "picky", preferred={0}).start_without_loop()
    assert picky.acquire_once() == {0} and picky.owned_shards() == {0}
    greedy = _manager(side, kube, cfg, "greedy").start_without_loop()
    assert greedy.acquire_once() == {1}
    time.sleep(0.25)
    assert 0 in greedy.acquire_once()
    assert greedy.owned_shards() == {0, 1}
    assert picky.owned_shards() == set()


def test_release_all_hands_off_immediately(side):
    kube, cfg = side.Fake(), _cfg(side, shard_count=1, shard_lease_duration_s=30.0)
    a = _manager(side, kube, cfg, "a").start_without_loop()
    b = _manager(side, kube, cfg, "b").start_without_loop()
    assert a.acquire_once() == {0} and b.acquire_once() == set()
    a.release_all()
    assert a.owned_shards() == set()
    assert b.acquire_once() == {0}


def test_renew_conflict_drops_local_claim(side):
    kube, cfg = side.Fake(), _cfg(side, shard_count=1, shard_lease_duration_s=30.0)
    a = _manager(side, kube, cfg, "a").start_without_loop()
    assert a.acquire_once() == {0}
    failures = side.shard.SHARD_RENEW_FAILURES._values.get((), 0.0)
    side.failpoints.arm("k8s.update_lease.status", "1*return(409)")
    try:
        a.acquire_once()
    finally:
        side.failpoints.disarm_all()
    assert a.owned_shards() == set()
    assert side.shard.SHARD_RENEW_FAILURES._values.get((), 0.0) == failures + 1
    assert a.acquire_once() == {0}


def test_on_takeover_fires_async_with_newly_acquired_set(side):
    m = _manager(side, side.Fake(), _cfg(side, shard_count=2), "m").start_without_loop()
    seen = []
    m.on_takeover = seen.append
    m.acquire_once()
    deadline = time.monotonic() + 5.0
    while not seen and time.monotonic() < deadline:
        time.sleep(0.01)
    assert seen == [{0, 1}]
    m.acquire_once()
    time.sleep(0.05)
    assert seen == [{0, 1}]


def test_table_shape(side):
    m = _manager(side, side.Fake(), _cfg(side, shard_count=2), "m", preferred={0},
                 url="http://m:8080").start_without_loop()
    m.acquire_once()
    table = m.table()
    assert table["replica"] == "m" and table["shardCount"] == 2 and table["active"]
    by_shard = {e["shard"]: e for e in table["shards"]}
    assert by_shard[0]["local"] and by_shard[0]["url"] == "http://m:8080"
    assert by_shard[0]["epoch"] == 1 and by_shard[0]["lease"] == "tpumounter-shard-0"
    assert by_shard[1]["holder"] is None


def test_the_loop_renews_and_stop_releases(side):
    """``start`` runs the renew loop on a thread; ``stop(release=True)``
    ends it and blanks the holder, so a peer claims at once."""
    kube = side.Fake()
    cfg = _cfg(side, shard_count=1, shard_lease_duration_s=30.0, shard_renew_interval_s=0.02)
    a = _manager(side, kube, cfg, "a").start()
    deadline = time.monotonic() + 5.0
    while not a.owned_shards() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert a.owned_shards() == {0}
    a.stop(release=True)
    assert side.shard.SHARDS_OWNED.get() == 0.0
    lease = kube.get_lease(a.lease_namespace, "tpumounter-shard-0")
    assert lease["spec"]["holderIdentity"] == ""
    b = _manager(side, kube, cfg, "b").start_without_loop()
    assert b.acquire_once() == {0}


def test_fake_lease_cas(side):
    kube = side.Fake()
    with pytest.raises(side.errors.NotFoundError):
        kube.get_lease("ns", "missing")
    created = kube.create_lease("ns", {"metadata": {"name": "l1"},
                                       "spec": {"holderIdentity": "x"}})
    with pytest.raises(side.errors.ConflictError):
        kube.create_lease("ns", {"metadata": {"name": "l1"}, "spec": {}})
    stale = dict(created, metadata={**created["metadata"], "resourceVersion": "999"})
    with pytest.raises(side.errors.ConflictError):
        kube.update_lease("ns", "l1", stale)
    fresh = kube.get_lease("ns", "l1")
    fresh["spec"]["holderIdentity"] = "y"
    updated = kube.update_lease("ns", "l1", fresh)
    assert updated["spec"]["holderIdentity"] == "y"
    assert updated["metadata"]["resourceVersion"] != created["metadata"]["resourceVersion"]


# --- the epochs (tests/test_fencing.py) ---

def test_shard_epoch_bumps_on_takeover(side):
    cfg = side.cfg(shard_count=1, shard_lease_duration_s=0.3, shard_preferred="")
    kube = side.Fake()
    first = _manager(side, kube, cfg, "rep-0", url="http://a").start_without_loop()
    first.acquire_once()
    assert first.owns_node("node-x") and first.node_epoch("node-x") == 1
    assert side.shard.epoch_kwargs(first, "node-x") == {"epoch": 1}
    second = _manager(side, kube, cfg, "rep-1", url="http://b").start_without_loop()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not second.owned_shards():
        second.acquire_once()
        time.sleep(0.05)
    assert second.owned_shards() == {0}
    assert second.node_epoch("node-x") == 2


def test_unsharded_epoch_is_zero(side):
    manager = side.shard.ShardManager(side.Fake(), cfg=side.cfg())
    assert manager.node_epoch("any-node") == 0
    assert side.shard.epoch_kwargs(manager, "any-node") == {}
    assert side.shard.epoch_kwargs(None, "any-node") == {}


def test_partitioned_owner_loses_claim_and_lease(side):
    cfg = side.cfg(shard_count=1, shard_lease_duration_s=0.3, shard_preferred="")
    kube = side.Fake()
    owner = _manager(side, kube, cfg, "rep-0", url="http://a").start_without_loop()
    owner.acquire_once()
    assert owner.owned_shards() == {0}
    kube.set_partitioned(True)
    try:
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and owner.owned_shards():
            owner.acquire_once()
            time.sleep(0.05)
        assert owner.owned_shards() == set()
        # a lost owner keeps stamping its stale epoch, which a worker fences
        assert owner.node_epoch("node-x") == 1
    finally:
        kube.set_partitioned(False)


# --- the lease under a partition (tests/test_api_outage.py) ---

@pytest.mark.parametrize("mode", ["reads", "writes", "full"])
def test_lease_acquire_survives_partitions_without_crashing(side, mode):
    fake = side.Fake()
    cfg = side.cfg(shard_count=2, shard_lease_duration_s=5.0, shard_preferred="")
    manager = _manager(side, fake, cfg, "rep-0").start_without_loop()
    fake.set_partitioned(True, mode=mode)
    assert manager.acquire_once() == set()
    assert manager.owned_shards() == set()
    fake.set_partitioned(False)
    manager.acquire_once()
    assert manager.owned_shards() == {0, 1}


def test_lease_renewal_failure_under_write_partition_loses_cleanly(side):
    fake = side.Fake()
    cfg = side.cfg(shard_count=1, shard_lease_duration_s=0.3, shard_preferred="")
    holder = _manager(side, fake, cfg, "holder").start_without_loop()
    holder.acquire_once()
    assert holder.owned_shards() == {0}
    fake.set_partitioned(True, mode="writes")
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and holder.owned_shards():
        holder.acquire_once()
        time.sleep(0.05)
    assert holder.owned_shards() == set()
    fake.set_partitioned(False)
    challenger = _manager(side, fake, cfg, "challenger").start_without_loop()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not challenger.owned_shards():
        challenger.acquire_once()
        time.sleep(0.05)
    assert challenger.owned_shards() == {0}
    assert holder.owned_shards() == set()


# --- entry.shard_pool_check on the fake host ---

def test_shard_pool_check_on_the_cpu():
    """Phase 16's flows on a fake host of 2 GPUs: warm hits then cold
    misses, the owner replica's epoch in the worker's ledger with the renew
    loops at the default lease, the 307 and the proxied batch, and the stale
    owner fenced with nothing changed."""
    from gpumounter_tpu_torch import entry
    from gpumounter_tpu_torch.k8s import health as k8s_health
    k8s_health.reset_all()
    report = entry.shard_pool_check("cpu", repeats=2)
    flows = report["fake"]
    assert report["live"] is None
    assert set(flows["start_ms"]) == {"pool", "replicas", "stale"}
    pool = flows["pool"]
    assert pool["epoch"] == pool["ledger_epoch"] == 1
    assert (pool["lease_s"], pool["renew_s"]) == (15.0, 5.0)
    assert len(pool["warm"]) == len(pool["cold"]) == 2 and pool["drained"] == 1
    replicas = flows["replicas"]
    assert replicas["redirect"].endswith("/gpu/1/isEntireMount/false")
    assert replicas["forwarded"] == "NotOwner" and len(replicas["proxied_ms"]) == 2
    assert sorted(replicas["epochs"]) == [0, 1]
    stale = flows["stale"]
    assert (stale["stale_epoch"], stale["fresh_epoch"], stale["ledger_epoch"]) == (1, 2, 2)
    assert "fenced by worker" in stale["fenced"] and stale["takeover_ms"] > 0
