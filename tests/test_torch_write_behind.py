"""The write-behind queue and the degraded store: the port's
``store/writebehind.py`` and ``store/cache.py`` against the reference's.

The cases of ``tests/test_write_behind.py``, each run on both packages
(``tests/torch_store_sides.py``): the queue's journal line by line (its
``queued_at`` masked), every flush outcome (applied, superseded, pod-gone,
lost-cas), the reload after a torn line, the compaction, a death in the
middle of a flush (it applies at most one write again), and the cached
store's deferral, ordering, bounded-staleness reads and write probe, with
the series they move. Then the two differences on purpose: the port cuts a
torn tail off the file at the reload, so that the next write survives the
next reload, and it fsyncs the queue's directory when the file is made and
after a compaction.
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture
from torch_store_sides import SIDES, both, fresh

from gpumounter_tpu_torch.store import writebehind

CFG = dict(api_health_degraded_failures=2, api_health_down_after_s=60.0,
           api_cache_max_staleness_s=300.0, k8s_write_attempts=2, k8s_write_retry_base_s=0.01)


def _lines(directory: str) -> list:
    out = []
    with open(os.path.join(directory, "writebehind.jsonl"), encoding="utf-8") as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                out.append("<torn>")
                continue
            rec.pop("queued_at", None)
            if "updated_at" in (rec.get("payload") or ""):  # a journal's stamp
                journal = json.loads(rec["payload"])
                journal.pop("updated_at")
                rec["payload"] = journal
            out.append(rec)
    return out


def _pending(queue) -> list:
    return [(r["seq"], r["annotation"], r["payload"]) for r in queue.pending()]


def _annotations(side, fake, name="p") -> dict:
    return side.Pod(fake.get_pod("default", name)).annotations


def _fake_with_pod(side, annotations=None):
    fake = side.FakeKubeClient()
    fake.create_pod("default", {"metadata": {"name": "p", **(
        {"annotations": annotations} if annotations else {})}})
    return fake


def _series(side) -> list:
    wb = side.writebehind
    cache = side.store.cache if hasattr(side.store, "cache") else None
    return [m.snapshot() for m in (wb.WRITEBEHIND_PENDING, wb.WRITEBEHIND_QUEUED,
                                    wb.WRITEBEHIND_REPLAYED, cache.STALE_READS,
                                    cache.DEFERRED_WRITES)]


def _reset_series(side) -> None:
    from importlib import import_module
    cache = import_module(f"{side.store.__name__}.cache")
    side.store.cache = cache
    for m in (side.writebehind.WRITEBEHIND_PENDING, side.writebehind.WRITEBEHIND_QUEUED,
              side.writebehind.WRITEBEHIND_REPLAYED, cache.STALE_READS, cache.DEFERRED_WRITES):
        m.reset()


# --- the queue, case by case ---

def durable_across_restart(side, d):
    q = side.Queue(d)
    q.enqueue("default", "p", "a/x", "v1")
    q.enqueue("default", "p", "a/y", "v2")
    q.close()
    return _pending(side.Queue(d))


def coalesces_newest_wins(side, d):
    q = side.Queue(d)
    for value in ("old", "newer", "newest"):
        q.enqueue("default", "p", "a/x", value)
    return _pending(q), q.stats()["closed"]


def flush_in_order_exactly_once(side, d):
    fake = _fake_with_pod(side)
    q = side.Queue(d)
    q.enqueue("default", "p", "a/x", "v1")
    q.enqueue("default", "p", "a/y", "v2")
    return q.flush(fake), _annotations(side, fake), q.flush(fake)


def flush_halts_on_outage_and_resumes(side, d):
    fake = _fake_with_pod(side)
    q = side.Queue(d)
    q.enqueue("default", "p", "a/x", "v1")
    fake.set_partitioned(True)
    halted = q.flush(fake)
    fake.set_partitioned(False)
    return halted, q.flush(fake)


def cas_drops_a_beaten_write(side, d):
    fake = _fake_with_pod(side, {"a/marker": json.dumps({"seq": 7, "who": "fresh"})})
    q = side.Queue(d)
    q.enqueue("default", "p", "a/marker", json.dumps({"seq": 3, "who": "stale"}))
    q.enqueue("default", "p", "a/gen", json.dumps({"generation": 2}))
    return q.flush(fake), _annotations(side, fake)


def cas_applies_a_newer_write(side, d):
    fake = _fake_with_pod(side, {"a/marker": json.dumps({"seq": 2})})
    q = side.Queue(d)
    q.enqueue("default", "p", "a/marker", json.dumps({"seq": 5}))
    return q.flush(fake), _annotations(side, fake)


def drops_writes_of_a_gone_pod(side, d):
    q = side.Queue(d)
    q.enqueue("default", "ghost", "a/x", "v")
    return q.flush(side.FakeKubeClient())


def torn_last_line_dropped(side, d):
    q = side.Queue(d)
    q.enqueue("default", "p", "a/x", "v1")
    q.close()
    with open(os.path.join(d, "writebehind.jsonl"), "ab") as f:
        f.write(b'{"kind":"write","seq":2,"namespa')  # a death in the append
    reloaded = side.Queue(d)
    seq = reloaded.enqueue("default", "p", "a/y", "v2")
    return _pending(reloaded), seq


def compaction_keeps_pending_only(side, d):
    q = side.Queue(d, max_bytes=4096)
    fake = _fake_with_pod(side)
    filler = "x" * 256
    for i in range(64):
        q.enqueue("default", "p", f"a/k{i % 4}", f"{filler}-{i}")
    summary = q.flush(fake)
    q.enqueue("default", "p", "a/last", "survivor")
    size = os.path.getsize(os.path.join(d, "writebehind.jsonl"))
    q.close()
    return summary, size < 4096 + 1024, _pending(side.Queue(d, max_bytes=4096))


def in_memory_defers_without_a_file(side, d):
    q = side.Queue("")
    q.enqueue("default", "p", "a/x", "v")
    return q.pending_count(), q.stats()["durable"], os.listdir(d)


class _Death(BaseException):
    """A process death between a patch and its done record."""


def death_in_a_flush_reapplies_at_most_one(side, d):
    fake = _fake_with_pod(side)
    patched = []
    real_patch = fake.patch_pod

    def patch(namespace, name, body):
        out = real_patch(namespace, name, body)
        annotation = next(iter(body["metadata"]["annotations"]))
        patched.append(annotation)
        if annotation == "a/2" and patched.count("a/2") == 1:
            raise _Death()
        return out

    fake.patch_pod = patch
    q = side.Queue(d)
    for i in (1, 2, 3):
        q.enqueue("default", "p", f"a/{i}", f"v{i}")
    with pytest.raises(_Death):
        q.flush(fake)
    q.close()  # the death: the file as the append left it
    reloaded = side.Queue(d)
    before = _pending(reloaded)
    summary = reloaded.flush(fake)
    return before, summary, patched, _annotations(side, fake)


QUEUE_CASES = [durable_across_restart, coalesces_newest_wins, flush_in_order_exactly_once,
               flush_halts_on_outage_and_resumes, cas_drops_a_beaten_write,
               cas_applies_a_newer_write, drops_writes_of_a_gone_pod, torn_last_line_dropped,
               compaction_keeps_pending_only, in_memory_defers_without_a_file,
               death_in_a_flush_reapplies_at_most_one]

EXPECTED = {
    "durable_across_restart": [(1, "a/x", "v1"), (2, "a/y", "v2")],
    "coalesces_newest_wins": ([(3, "a/x", "newest")], {"superseded": 2}),
    "drops_writes_of_a_gone_pod": {"applied": 0, "pod_gone": 1, "lost_cas": 0, "pending": 0,
                                   "error": ""},
    "torn_last_line_dropped": ([(1, "a/x", "v1"), (2, "a/y", "v2")], 2),
}


@pytest.mark.parametrize("case", QUEUE_CASES, ids=lambda c: c.__name__)
def test_a_queue_case_journals_as_the_references(tmp_path, case):
    got = {}
    for name, side in SIDES.items():
        d = str(tmp_path / name)
        os.makedirs(d)
        _reset_series(side)
        result = case(side, d)
        journal = _lines(d) if os.path.exists(os.path.join(d, "writebehind.jsonl")) else None
        if case is compaction_keeps_pending_only:
            # where the compactions fall depends on the printed length of
            # each line's queued_at: the pending writes it keeps are compared
            journal = None
        got[name] = (result, journal, _series(side)[:3])
    if case is torn_last_line_dropped:
        # the difference on purpose (below): the port cut the torn tail, so
        # seq 2 has a line of its own; the reference's joined the fragment
        assert got["port"][1][-1]["seq"] == 2 and got["reference"][1][-1] == "<torn>"
        for name in got:
            got[name] = (got[name][0], got[name][1][:-1], got[name][2])
    assert got["port"] == got["reference"]
    if case.__name__ in EXPECTED:
        assert got["port"][0] == EXPECTED[case.__name__]
    if case is death_in_a_flush_reapplies_at_most_one:
        before, summary, patched, annotations = got["port"][0]
        assert before == [(2, "a/2", "v2"), (3, "a/3", "v3")]
        assert patched == ["a/1", "a/2", "a/2", "a/3"]  # a/2 twice: once again, at most
        assert summary["applied"] == 2 and annotations == {"a/1": "v1", "a/2": "v2", "a/3": "v3"}
    if case is cas_drops_a_beaten_write:
        assert got["port"][0][0]["lost_cas"] == 1 and got["port"][0][0]["applied"] == 1


# --- the degraded store ---

def _store(side, d, fake=None, **changes):
    fake = fake or side.FakeKubeClient()
    cfg = fresh(side, **CFG, writebehind_dir=d, **changes)
    health = side.ApiHealth(cfg=cfg)
    store = side.store.CachedMasterStore(
        side.store.KubeMasterStore(side.Tracking(fake, health), cfg), cfg=cfg, apihealth=health)
    return store, fake, health


def defers_during_outage_and_flushes(side, d):
    store, fake, health = _store(side, d)
    fake.create_pod("default", {"metadata": {"name": "p"}})
    fake.set_partitioned(True)
    store.stamp_annotation("default", "p", "a/x", "deferred-value")
    journal = side.journal.new_journal("mig-1", "default", "p", "default", "q")
    journal["created_at"] = 1.0
    store.save_journal(journal)
    steps = [store.queue.pending_count(), health.ok(), health.plane_state("write")]
    fake.set_partitioned(False)
    steps.append(store.flush_writes())
    annotations = _annotations(side, fake)
    steps += [annotations["a/x"], json.loads(annotations["tpumounter.io/migration"])["id"]]
    return steps


def short_circuits_when_the_write_plane_is_down(side, d):
    store, fake, health = _store(side, d)
    fake.create_pod("default", {"metadata": {"name": "p"}})
    health.down_after_s = 0.0
    for _ in range(2):
        health.record_failure(side.errors.PartitionError("x"), kind="write")
    calls = []
    real_patch = fake.patch_pod
    fake.patch_pod = lambda *a: (calls.append(a), real_patch(*a))[1]
    store.stamp_annotation("default", "p", "a/x", "v")
    return health.plane_state("write"), store.queue.pending_count(), calls


def keeps_order_once_a_key_is_queued(side, d):
    store, fake, _ = _store(side, d)
    fake.create_pod("default", {"metadata": {"name": "p"}})
    fake.set_partitioned(True)
    store.stamp_annotation("default", "p", "a/x", "old-queued")
    fake.set_partitioned(False)
    store.stamp_annotation("default", "p", "a/x", "newest")
    count = store.queue.pending_count()
    store.flush_writes()
    return count, _annotations(side, fake)["a/x"]


def serves_bounded_stale_reads(side, d):
    store, fake, _ = _store(side, d)
    cfg = store.cfg
    fake.create_pod(cfg.worker_namespace, {
        "metadata": {"name": "w1", "namespace": cfg.worker_namespace,
                     "labels": dict([cfg.worker_label_selector.split("=")])},
        "spec": {"nodeName": "n1"}, "status": {"phase": "Running", "podIP": "10.0.0.1"}})
    fresh_read = [side.Pod(p).name for p in store.list_worker_pods()]
    fake.set_partitioned(True)
    stale = [side.Pod(p).name for p in store.list_worker_pods()]
    ages = sorted(store.staleness())
    store.max_staleness_s = 0.0  # everything is too old now
    with pytest.raises(side.errors.PartitionError):
        store.list_worker_pods()
    return fresh_read, stale, ages


def never_caches_node_readiness(side, d):
    store, fake, _ = _store(side, d)
    node = {"metadata": {"name": "n1"}}
    fake.get_node = lambda name: node
    first = store.get_node("n1")
    fake.set_partitioned(True)

    def down(name):
        fake._check_partition("read")
    fake.get_node = down
    return first, store.get_node("n1")


def intents_are_never_deferred(side, d):
    store, fake, _ = _store(side, d)
    fake.create_pod("default", {"metadata": {"name": "p"}})
    fake.set_partitioned(True)
    with pytest.raises(side.errors.PartitionError):
        store.put_intent("default", "p", side.Intent(desired_chips=1))
    with pytest.raises(side.errors.PartitionError):
        store.delete_intent("default", "p")
    return store.queue.pending_count()


def flushes_on_recovery(side, d):
    store, fake, health = _store(side, d)
    fake.create_pod("default", {"metadata": {"name": "p"}})
    fake.set_partitioned(True)
    store.stamp_annotation("default", "p", "a/x", "auto")
    queued = store.queue.pending_count()
    fake.set_partitioned(False)
    health.record_success(kind="write")
    health.record_success(kind="write")  # -> healthy: the subscriber flushes on a thread
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and (store.queue.pending_count() or any(
            t.name == "writebehind-flush" for t in threading.enumerate())):
        time.sleep(0.01)
    return queued, store.queue.pending_count(), _annotations(side, fake)["a/x"]


def not_found_evicts(side, d):
    store, fake, _ = _store(side, d)
    fake.create_pod("default", {"metadata": {"name": "t1"}})
    store.get_intent("default", "t1")  # cached
    fake.delete_pod("default", "t1")
    with pytest.raises(side.errors.NotFoundError):
        store.get_intent("default", "t1")
    fake.set_partitioned(True)
    with pytest.raises(side.errors.PartitionError):  # nothing stale served
        store.get_intent("default", "t1")
    return sorted(store.staleness())


def pool_pods_and_journals_from_cache(side, d):
    store, fake, _ = _store(side, d)
    pool = store.cfg.pool_namespace
    fake.set_partitioned(True)
    with pytest.raises(side.errors.PartitionError):
        store.scan_journals()
    with pytest.raises(side.errors.PartitionError):
        store.list_pool_pods("n1")
    fake.set_partitioned(False)
    fake.create_pod(pool, {"metadata": {"name": "slave-1", "namespace": pool},
                           "spec": {"nodeName": "n1"}, "status": {"phase": "Running"}})
    primed = [side.Pod(p).name for p in store.list_pool_pods("n1")]
    store.scan_journals()
    fake.set_partitioned(True)
    return primed, [side.Pod(p).name for p in store.list_pool_pods("n1")], store.scan_journals()


def _prober_stopped(store) -> bool:
    """Wait for the store's write probe to return (it logs its last flush
    after the queue empties): nothing of the case outlives it."""
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and store._prober_running:
        time.sleep(0.01)
    return not store._prober_running


def probe_recovers_an_idle_master(side, d):
    store, fake, health = _store(side, d, api_health_probe_interval_s=0.05)
    fake.create_pod("default", {"metadata": {"name": "p"}})
    fake.set_partitioned(True)
    store.stamp_annotation("default", "p", "a/x", "v")
    unhealthy = not health.ok()
    fake.set_partitioned(False)  # healed; no traffic of ours
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and (not health.ok() or store.queue.pending_count()):
        time.sleep(0.02)
    return unhealthy, health.ok(), store.queue.pending_count(), \
        _annotations(side, fake)["a/x"], _prober_stopped(store)


def probe_touches_a_lease_with_nothing_queued(side, d):
    store, fake, health = _store(side, d, api_health_probe_interval_s=0.05)
    for _ in range(2):
        health.record_failure(side.errors.PartitionError("outage"), kind="write")
    unhealthy = not health.ok()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not health.ok():
        time.sleep(0.02)
    lease = fake.get_lease(store.cfg.worker_namespace, store.PROBE_LEASE)
    return unhealthy, health.ok(), lease["metadata"]["name"], _prober_stopped(store)


STORE_CASES = [defers_during_outage_and_flushes, short_circuits_when_the_write_plane_is_down,
               keeps_order_once_a_key_is_queued, serves_bounded_stale_reads,
               never_caches_node_readiness, intents_are_never_deferred, flushes_on_recovery,
               not_found_evicts, pool_pods_and_journals_from_cache,
               probe_recovers_an_idle_master, probe_touches_a_lease_with_nothing_queued]

STORE_EXPECTED = {
    "short_circuits_when_the_write_plane_is_down": ("down", 1, []),
    "keeps_order_once_a_key_is_queued": (1, "newest"),
    "serves_bounded_stale_reads": (["w1"], ["w1"], ["worker_pods"]),
    "never_caches_node_readiness": ({"metadata": {"name": "n1"}}, None),
    "intents_are_never_deferred": 0,
    "flushes_on_recovery": (1, 0, "auto"),
    "not_found_evicts": [],
    "pool_pods_and_journals_from_cache": (["slave-1"], ["slave-1"], []),
    "probe_recovers_an_idle_master": (True, True, 0, "v", True),
    "probe_touches_a_lease_with_nothing_queued": (True, True, "tpumounter-apihealth-probe",
                                                  True),
}


@pytest.mark.parametrize("case", STORE_CASES, ids=lambda c: c.__name__)
def test_a_degraded_store_case_runs_as_the_references(tmp_path, case):
    got = {}
    for name, side in SIDES.items():
        d = str(tmp_path / name)
        _reset_series(side)
        result = case(side, d)
        journal = _lines(d) if os.path.exists(os.path.join(d, "writebehind.jsonl")) else None
        got[name] = (result, journal, _series(side)[1:])
    assert got["port"] == got["reference"]
    if case.__name__ in STORE_EXPECTED:
        assert got["port"][0] == STORE_EXPECTED[case.__name__]
    if case is defers_during_outage_and_flushes:
        steps = got["port"][0]
        assert steps[:3] == [2, False, "degraded"] and steps[3]["applied"] == 2
        assert steps[4:] == ["deferred-value", "mig-1"]


def test_a_closed_store_leaves_apihealth_and_ends_its_probe(tmp_path):
    """close() unsubscribes the store from the process-wide ApiHealth, ends
    its write probe and closes its queue, so that a master's store does not
    outlive the master."""
    side = SIDES["port"]
    store, fake, health = _store(side, str(tmp_path), api_health_probe_interval_s=0.01)
    fake.create_pod("default", {"metadata": {"name": "p"}})
    fake.set_partitioned(True)
    for i in range(2):
        store.stamp_annotation("default", "p", f"a/{i}", "v")
    assert health.state() == "degraded" and store._prober_running
    assert store._on_health_transition in health._subscribers
    store.close()
    deadline = time.monotonic() + 5.0
    while store._prober_running:
        assert time.monotonic() < deadline, "the probe did not end"
        time.sleep(0.01)
    assert store._on_health_transition not in health._subscribers
    assert store.queue._fd is None and len(store.queue.pending()) == 2


# --- the differences on purpose: the torn tail's cut and the directory's fsync ---

def test_a_reload_cuts_the_torn_tail_so_the_next_write_survives_the_next(tmp_path):
    """After a death in an append, the reload cuts the fragment off the
    file: the next write, fsync'd and acknowledged, starts a line of its
    own and a second reload still holds it. The reference leaves the
    fragment, the write is appended onto it, and its second reload loses
    the write."""
    got = {}
    for name, side in SIDES.items():
        d = str(tmp_path / name)
        os.makedirs(d)
        q = side.Queue(d)
        q.enqueue("default", "p", "a/x", "v1")
        q.close()
        with open(os.path.join(d, "writebehind.jsonl"), "ab") as f:
            f.write(b'{"kind":"write","seq":2,"namespa')  # a death in the append
        q = side.Queue(d)
        q.enqueue("default", "p", "a/y", "v2")  # acknowledged
        q.close()
        q = side.Queue(d)
        got[name] = (_pending(q), [r if r == "<torn>" else r["seq"] for r in _lines(d)])
        q.close()
    assert got["port"] == ([(1, "a/x", "v1"), (2, "a/y", "v2")], [1, 2])
    assert got["reference"] == ([(1, "a/x", "v1")], [1, "<torn>"])


def test_the_queue_fsyncs_its_directory_on_create_and_compaction(tmp_path, monkeypatch):
    """A new file and a compaction's rename reach the directory's entry, so
    that after a node crash it names the file the fsync'd lines went into
    (the reference fsyncs the file and the temporary file only)."""
    synced = []
    fsync_dir = writebehind._fsync_dir
    monkeypatch.setattr(writebehind, "_fsync_dir", lambda d: (synced.append(d), fsync_dir(d)))
    d = str(tmp_path / "wb")
    q = writebehind.WriteBehindQueue(d, max_bytes=4096)
    assert synced == [d]
    q.close()
    q = writebehind.WriteBehindQueue(d, max_bytes=4096)
    assert synced == [d]  # the file was there: no new entry
    i = 0
    while len(synced) < 2:
        q.enqueue("default", "p", f"a/k{i}", "x" * 256)
        i += 1
    assert synced == [d, d]
    q.close()
    assert len(writebehind.WriteBehindQueue(d, max_bytes=4096).pending()) == i
