"""The watch-backed store: the port's ``store/watch.py`` against the
reference's, on ``tests/test_watch_store.py``'s cases, each run on both
packages (``tests/torch_store_sides.py``) with what it returns compared: a
synced store reads with no LIST, a clean stream end watches again without
one, a 410 after a storm past the watch backlog relists and converges on the
list-backed store's answers, a replica reads its own writes while its
stream is down and the overlay retires when the stream catches up, reads
before the first sync go through the list-backed store (its errors too), it
layers under the outage cache, the master takes it behind
TPUMOUNTER_WATCH_STORE, and the pool pods' index follows a pod across
nodes. Then the one difference on purpose: the master's worker registry
rides the watch store's own stream instead of a second watch of the API.
"""

from __future__ import annotations

import time

import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture
from torch_store_sides import SIDES, fresh, pod, worker_pod

from gpumounter_tpu.master import app as ref_app
from gpumounter_tpu_torch.k8s import fake as port_fake
from gpumounter_tpu_torch.master import app as port_app

WATCH = dict(store_watch_timeout_s=0.2, store_watch_relist_base_s=0.05,
             store_watch_relist_cap_s=0.2)
DESIRED = "tpumounter.io/desired-chips"


@pytest.fixture()
def small_backlog(monkeypatch):
    """A watch backlog of 64 events on both fakes: the reference's from its
    config, the port's from its module's bound."""
    monkeypatch.setattr(port_fake, "MAX_EVENTS", 64)


def _kube(side):
    if side.kind == "reference":
        return side.FakeKubeClient(cfg=fresh(side, watch_backlog_events=64))
    return side.FakeKubeClient()


def _counting_lists(kube) -> list:
    calls = []
    for name in ("list_pods", "list_pods_with_rv"):
        real = getattr(kube, name)
        setattr(kube, name, lambda *a, _real=real, _n=name, **k: (calls.append(_n),
                                                                 _real(*a, **k))[1])
    return calls


def _synced(side, kube, **changes):
    store = side.store.WatchMasterStore(kube, fresh(side, **WATCH, **changes))
    assert store.wait_synced(10.0)
    return store


def _intents(store) -> list:
    return sorted((ns, name, i.to_json()) for ns, name, i in store.list_intents())


def synced_reads_list_nothing(side):
    kube = _kube(side)
    for i in range(20):
        pod(kube, f"t-{i}", annotations={DESIRED: str(i % 4 + 1)})
    store = _synced(side, kube)
    try:
        calls = _counting_lists(kube)
        sizes = set()
        for _ in range(50):
            sizes.add(len(store.list_intents()))
            store.scan_journals()
            store.list_pool_pods("node-0")
        return sizes, calls
    finally:
        store.stop()


def clean_ends_watch_again_without_a_list(side):
    kube = _kube(side)
    pod(kube, "a")
    store = _synced(side, kube)
    try:
        for i in range(4):  # past several 0.2 s watch windows
            time.sleep(0.25)
            pod(kube, f"late-{i}")
        assert store.quiesce(5.0)
        return sorted(name for _, name in store._pods), store.relists
    finally:
        store.stop()


def gone_after_a_storm_relists_and_converges(side):
    kube = _kube(side)
    pod(kube, "seed")
    store = _synced(side, kube)
    try:
        kube.set_partitioned(True, mode="reads")
        time.sleep(0.5)  # the open stream ends; opening another fails
        for i in range(200):  # past the backlog of 64: the cursor expires
            pod(kube, f"storm-{i}", annotations={DESIRED: "1"})
        kube.set_partitioned(False)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if store.payload()["indexes"]["pods"] == 201 and store.quiesce(1.0):
                break
        listed = side.store.KubeMasterStore(kube, store.cfg)
        return (_intents(store) == _intents(listed), len(store.list_intents()),
                store.relists >= 2)
    finally:
        store.stop()


def reads_its_own_writes_while_the_stream_is_down(side):
    kube = _kube(side)
    pod(kube, "tenant")
    store = _synced(side, kube)
    try:
        kube.set_partitioned(True, mode="reads")
        store.put_intent("default", "tenant", side.Intent(desired_chips=4, min_chips=2))
        out = [store.get_intent("default", "tenant").to_json(), _intents(store),
               store.delete_intent("default", "tenant"), store.get_intent("default", "tenant")]
        kube.set_partitioned(False)
        return out
    finally:
        store.stop()


def overlay_retires(side):
    kube = _kube(side)
    pod(kube, "tenant")
    store = _synced(side, kube)
    try:
        store.put_intent("default", "tenant", side.Intent(desired_chips=2))
        settled = store.quiesce(5.0)
        return settled, store.payload()["overlays"], \
            store.get_intent("default", "tenant").to_json()
    finally:
        store.stop()


def reads_before_the_sync_go_through(side):
    kube = _kube(side)
    pod(kube, "tenant", annotations={DESIRED: "2"})
    store = side.store.WatchMasterStore(kube, fresh(side, **WATCH,
                                                    store_watch_sync_timeout_s=0.05),
                                        start=False)  # never syncs
    calls = _counting_lists(kube)
    out = [_intents(store), bool(calls)]
    kube.set_partitioned(True)
    with pytest.raises(side.errors.PartitionError):
        store.scan_journals()
    kube.set_partitioned(False)
    return out + [store.payload()["synced"]]


def layers_under_the_outage_cache(side):
    kube = _kube(side)
    pod(kube, "tenant", annotations={DESIRED: "3"})
    inner = _synced(side, kube)
    try:
        outer = side.store.CachedMasterStore(inner, cfg=inner.cfg,
                                             apihealth=side.ApiHealth(cfg=inner.cfg))
        payload = outer.payload()["watch"]
        return inner.kube is kube, _intents(outer), payload["synced"], payload["indexes"]
    finally:
        inner.stop()


def the_master_takes_it_behind_its_flag(side):
    app_mod = ref_app if side.kind == "reference" else port_app
    out = []
    for enabled in (True, False):
        cfg = fresh(side, **WATCH, store_watch_enabled=enabled)
        app = app_mod.MasterApp(side.FakeKubeClient(), cfg=cfg)
        out.append(type(app.store.inner).__name__)
        if enabled:
            app.store.inner.stop()
    return out


def pool_index_follows_a_node_move(side):
    kube = _kube(side)
    pool = side.Config().pool_namespace
    pod(kube, "p1", namespace=pool, node="n1")
    store = _synced(side, kube)
    names = lambda node: [p["metadata"]["name"] for p in store.list_pool_pods(node)]  # noqa: E731
    try:
        out = [names("n1")]
        kube.patch_pod(pool, "p1", {"spec": {"nodeName": "n2"}})
        assert store.quiesce(5.0)
        out += [names("n1"), names("n2")]
        kube.delete_pod(pool, "p1")
        assert store.quiesce(5.0)
        return out + [names("n2")]
    finally:
        store.stop()


EXPECTED = {
    synced_reads_list_nothing: ({20}, []),
    clean_ends_watch_again_without_a_list: (["a", "late-0", "late-1", "late-2", "late-3"], 1),
    gone_after_a_storm_relists_and_converges: (True, 200, True),
    reads_its_own_writes_while_the_stream_is_down: [
        {"desiredChips": 4, "minChips": 2, "priority": 0},
        [("default", "tenant", {"desiredChips": 4, "minChips": 2, "priority": 0})], True, None],
    overlay_retires: (True, 0, {"desiredChips": 2, "minChips": 0, "priority": 0}),
    reads_before_the_sync_go_through: [
        [("default", "tenant", {"desiredChips": 2, "minChips": 0, "priority": 0})], True, False],
    layers_under_the_outage_cache: (
        True, [("default", "tenant", {"desiredChips": 3, "minChips": 0, "priority": 0})], True,
        {"pods": 1, "workers": 0, "intents": 1, "journals": 0, "pool_nodes": 0}),
    the_master_takes_it_behind_its_flag: ["WatchMasterStore", "KubeMasterStore"],
    pool_index_follows_a_node_move: [["p1"], [], ["p1"], []],
}


@pytest.mark.parametrize("case", list(EXPECTED), ids=lambda c: c.__name__)
def test_a_watch_store_case_runs_as_the_references(case, small_backlog):
    got = {name: case(side) for name, side in SIDES.items()}
    assert got["port"] == got["reference"] == EXPECTED[case]


def _until(predicate, timeout_s: float = 5.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def test_the_registry_rides_the_watch_stores_stream():
    """With the watch store on, the master's registry takes the worker
    pods' events from the store's own stream: the API serves one watch, and
    no second one of the worker pods beside it (the reference's registry
    opens its own). A relist ends the registry's stream and it LISTs the
    fresh indexes again; the master's close ends the streams and leaves
    ApiHealth."""
    side = SIDES["port"]
    kube = side.FakeKubeClient()
    selected = []
    real_watch = kube.watch_pods

    def watch_pods(namespace, **kwargs):
        if kwargs.get("label_selector"):
            selected.append(namespace)  # a watch of the worker pods alone
        return real_watch(namespace, **kwargs)

    kube.watch_pods = watch_pods
    cfg = fresh(side, **WATCH, store_watch_enabled=True)
    worker_pod(kube, cfg, "w1", "n1", "10.0.0.1")
    app = port_app.MasterApp(kube, cfg=cfg)
    snapshot = app.registry.registry_snapshot
    watch = app.store.inner
    try:
        assert snapshot() == {"n1": "10.0.0.1"}
        worker_pod(kube, cfg, "w2", "n2", "10.0.0.2")
        _until(lambda: snapshot().get("n2") == "10.0.0.2")
        _until(lambda: len(watch._worker_streams) == 1)
        relists = watch.relists
        watch._relist("test")  # as after a 410
        assert watch.relists == relists + 1 and watch._worker_streams == []
        worker_pod(kube, cfg, "w3", "n3", "10.0.0.3")
        _until(lambda: snapshot().get("n3") == "10.0.0.3")
        kube.delete_pod(cfg.worker_namespace, "w1")
        _until(lambda: "n1" not in snapshot())
        _until(lambda: len(watch._worker_streams) == 1)
        assert selected == []
    finally:
        app.close()
    assert watch._worker_streams == []
    assert app.store._on_health_transition not in app.apihealth._subscribers
