"""The API outage end to end: the port against the reference on
``tests/test_api_outage.py``'s cases that need neither the shard leases, the
recovery controller, the warm pool nor the migration machine, and on the
partitions, leases and resumable LIST of ``tests/test_k8s_fake.py``.

Each case runs on both packages (``tests/torch_store_sides.py``) and what it
returns is compared: a reads partition serves the store from its cache while
writes land; a writes partition defers them while reads stay fresh; the
registry answers from its cache through a reads partition; the watch's
jittered backoff, its bound on streams that end at once, and its reset after
a stream that lived; the deferred releases' retry, one record while the
write plane is down, on both services; the fake's partition by plane,
leases with CAS, and a LIST's resourceVersion to watch from. Then
``entry.degraded_check`` on the fake host. Then the migration machine: its
pause at a phase boundary, its scan of the memory's journals when the store
cannot answer, and a phase failing in an outage (rolled back under a verdict
still healthy, held under one that is down), on both packages; and chaos
invariant 14, ``run_api_outage_scenario`` in its four flavors on the
reference's seeds with its negative control, on the port's harness, whose
migrate flavor meets the machine in a phase drawn from the seed.
"""

from __future__ import annotations

import tempfile
import threading
import time

import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture
from torch_store_sides import SIDES, both, fresh, pod, worker_pod

from gpumounter_tpu.master import app as ref_app
from gpumounter_tpu.migrate import orchestrator as ref_orchestrator
from gpumounter_tpu.worker import ledger as ref_ledger
from gpumounter_tpu.worker import server as ref_server
import gpumounter_tpu_torch.entry as entry
from gpumounter_tpu_torch.master import app as port_app
from gpumounter_tpu_torch.migrate import orchestrator as port_orchestrator
from gpumounter_tpu_torch.worker import ledger as port_ledger
from gpumounter_tpu_torch.worker import server as port_server

CFG = dict(api_health_degraded_failures=2, api_health_down_after_s=60.0, k8s_write_attempts=2,
           k8s_write_retry_base_s=0.01)
APPS = {"reference": ref_app, "port": port_app}


def _store(side, d):
    fake = side.FakeKubeClient()
    cfg = fresh(side, **CFG, writebehind_dir=d)
    health = side.ApiHealth(cfg=cfg)
    store = side.store.CachedMasterStore(
        side.store.KubeMasterStore(side.Tracking(fake, health), cfg), cfg=cfg, apihealth=health)
    return store, fake, health


# --- the store's partitions, by plane ---

def test_a_reads_partition_serves_the_cache_and_lands_writes_as_the_references(tmp_path):
    def case(side):
        store, fake, health = _store(side, str(tmp_path / side.kind))
        worker_pod(fake, store.cfg)
        fake.create_pod("default", {"metadata": {"name": "p"}})
        primed = len(store.list_worker_pods())
        fake.set_partitioned(True, mode="reads")
        stale = [side.Pod(p).name for p in store.list_worker_pods()]
        store.stamp_annotation("default", "p", "a/x", "direct")
        out = [primed, stale, store.queue.pending_count(), health.plane_state("read"),
               health.plane_state("write")]
        fake.set_partitioned(False)
        return out + [side.Pod(fake.get_pod("default", "p")).annotations["a/x"]]
    got = both(case)
    assert got["port"] == got["reference"] == [1, ["w1"], 0, "healthy", "healthy", "direct"]


def test_a_writes_partition_defers_writes_and_reads_stay_fresh_as_the_references(tmp_path):
    def case(side):
        store, fake, health = _store(side, str(tmp_path / side.kind))
        fake.create_pod("default", {"metadata": {"name": "p"}})
        fake.set_partitioned(True, mode="writes")
        store.stamp_annotation("default", "p", "a/x", "queued")
        kube = side.Tracking(fake, health)
        out = [store.queue.pending_count(), side.Pod(kube.get_pod("default", "p")).name,
               health.plane_state("read"), health.plane_state("write")]
        fake.set_partitioned(False)
        return out + [store.flush_writes()["applied"]]
    got = both(case)
    assert got["port"] == got["reference"] == [1, "p", "healthy", "degraded", 1]


# --- the registry through an outage ---

def test_the_registry_answers_from_its_cache_through_a_reads_partition():
    def case(side):
        fake = side.FakeKubeClient()
        cfg = fresh(side, **CFG)
        worker_pod(fake, cfg, node="n1", ip="10.0.0.9")
        registry = APPS[side.kind].WorkerRegistry(fake, cfg)
        try:
            out = [registry.worker_address("n1")]
            fake.set_partitioned(True, mode="reads")
            out.append(registry.worker_address("n1"))
            return [a.split(":")[0] for a in out]
        finally:
            fake.set_partitioned(False)
            registry.stop()
    got = both(case)
    assert got["port"] == got["reference"] == ["10.0.0.9", "10.0.0.9"]


def test_the_watch_backoff_grows_with_jitter_as_the_references():
    def case(side):
        cls = APPS[side.kind].WorkerRegistry
        registry = cls.__new__(cls)  # no threads
        low = [registry._watch_backoff(1) for _ in range(50)]
        high = [registry._watch_backoff(10) for _ in range(50)]
        return (all(0.25 <= d <= 0.5 for d in low), all(7.5 <= d <= 15.0 for d in high),
                len(set(low)) > 1, cls.WATCH_BACKOFF_CAP_S)
    got = both(case)
    assert got["port"] == got["reference"] == (True, True, True, 15.0)


class _InstantEndStore:
    """Every watch ends at once with no error: a 410's shape."""

    def __init__(self):
        self.opens = 0

    def list_worker_pods(self):
        return []

    def watch_worker_pods(self, timeout_s=60.0):
        self.opens += 1
        return iter(())


def test_streams_that_end_at_once_do_not_loop_tight_as_the_references():
    def case(side):
        registry = APPS[side.kind].WorkerRegistry(side.FakeKubeClient(), fresh(side, **CFG))
        registry.store = _InstantEndStore()
        registry._ensure_started()
        time.sleep(1.2)
        registry.stop()
        return registry.store.opens <= 5
    assert both(case) == {"reference": True, "port": True}


def test_a_stream_that_lived_resets_the_backoff_as_the_references():
    def case(side):
        registry = APPS[side.kind].WorkerRegistry(side.FakeKubeClient(), fresh(side, **CFG))
        registry.MIN_HEALTHY_WATCH_S = 0.05
        failures = []
        registry._watch_backoff = lambda n: (failures.append(n), 0.01)[1]
        error = side.errors.PartitionError

        class _LongThenError(_InstantEndStore):
            def watch_worker_pods(self, timeout_s=60.0):
                def stream():
                    time.sleep(0.08)  # a healthy lifetime, then a transport error
                    raise error("LB reset")
                    yield  # a generator
                return stream()

        registry.store = _LongThenError()
        registry._ensure_started()
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and len(failures) < 4:
            time.sleep(0.02)
        registry.stop()
        return len(failures) >= 4, set(failures)
    got = both(case)
    assert got["port"] == got["reference"] == (True, {1})


# --- the worker's deferred releases ---

def test_the_deferred_release_retry_is_bounded_while_the_write_plane_is_down():
    """retry_pending_releases(limit=1) tries one record while the API is
    partitioned and reports the whole backlog; healed, all close. On both
    services, as the reference's test builds its service."""
    services = {"reference": (ref_server.TpuMountService, ref_ledger.MountLedger),
                "port": (port_server.GpuMountService, port_ledger.MountLedger)}

    def case(side):
        service_cls, ledger_cls = services[side.kind]
        fake = side.FakeKubeClient()
        with tempfile.TemporaryDirectory() as led_dir:
            ledger = ledger_cls(led_dir)
            service = service_cls.__new__(service_cls)
            service.cfg, service.kube, service.ledger = fresh(side, **CFG), fake, ledger
            for i in range(4):
                ledger.queue_release(service.cfg.pool_namespace, [f"slave-{i}"])
            fake.set_partitioned(True)
            attempts = []
            delete = fake.delete_pod
            fake.delete_pod = lambda ns, name, **kw: (attempts.append(name),
                                                      delete(ns, name, **kw))[1]
            during = service.retry_pending_releases(limit=1)
            fake.set_partitioned(False)
            after = service.retry_pending_releases()
            ledger.abandon()
            return list(attempts), during, after
    got = both(case)
    assert got["port"] == got["reference"] == (
        ["slave-0", "slave-0", "slave-1", "slave-2", "slave-3"],
        {"completed": 0, "pending": 4}, {"completed": 4, "pending": 0})


# --- the fake API server (tests/test_k8s_fake.py) ---

CALLS = {
    "get_pod": ("read", lambda k: k.get_pod("default", "p")),
    "list_pods": ("read", lambda k: k.list_pods("default")),
    "list_pods_with_rv": ("read", lambda k: k.list_pods_with_rv("default")),
    "watch_pods": ("read", lambda k: k.watch_pods("default", timeout_s=0.01)),
    "get_lease": ("read", lambda k: k.get_lease("ns", "l")),
    "create_pod": ("write", lambda k: k.create_pod("default", {"metadata": {"name": "q"}})),
    "patch_pod": ("write", lambda k: k.patch_pod("default", "p", {"metadata": {}})),
    "delete_pod": ("write", lambda k: k.delete_pod("default", "p")),
    "create_lease": ("write", lambda k: k.create_lease("ns", {"metadata": {"name": "m"}})),
    "update_lease": ("write", lambda k: k.update_lease("ns", "l", {"metadata": {}})),
}


@pytest.mark.parametrize("mode", ["full", "reads", "writes"])
def test_the_fake_partitions_a_plane_as_the_references(mode):
    def case(side):
        out = {}
        for name, (_, call) in CALLS.items():
            fake = side.FakeKubeClient()
            for name_ in ("p", "keep"):
                fake.create_pod("default", {"metadata": {"name": name_}})
            lease = fake.create_lease("ns", {"metadata": {"name": "l"}})
            open_watch = iter(fake.watch_pods("default", field_selector="metadata.name=keep",
                                              timeout_s=2.0))
            fake.set_partitioned(True, mode=mode)
            try:
                call(fake) if name != "update_lease" else fake.update_lease("ns", "l", lease)
                out[name] = "ok"
            except side.errors.PartitionError as exc:
                out[name] = exc.status
            fake.set_partitioned(False)
            fake.patch_pod("default", "keep", {"metadata": {"labels": {"x": "1"}}})
            out[name] = (out[name], next(open_watch)[0])  # an open watch runs on
        with pytest.raises(ValueError):
            side.FakeKubeClient().set_partitioned(True, mode="sideways")
        return out
    got = both(case)
    assert got["port"] == got["reference"]
    planes = {"full": ("read", "write"), "reads": ("read",), "writes": ("write",)}[mode]
    assert {name: got["port"][name][0] for name in CALLS} == {
        name: 503 if plane in planes else "ok" for name, (plane, _) in CALLS.items()}


def test_leases_are_a_cas_on_the_resource_version_as_the_references():
    def case(side):
        fake = side.FakeKubeClient()
        out = []
        with pytest.raises(side.errors.NotFoundError):
            fake.get_lease("ns", "l")
        first = fake.create_lease("ns", {"metadata": {"name": "l"}, "spec": {"holder": "a"}})
        out.append(first["metadata"])
        with pytest.raises(side.errors.ConflictError):
            fake.create_lease("ns", {"metadata": {"name": "l"}})
        renewed = fake.update_lease("ns", "l", dict(first, spec={"holder": "b"}))
        out.append((renewed["metadata"], renewed["spec"]))
        with pytest.raises(side.errors.ConflictError):  # a stale version loses
            fake.update_lease("ns", "l", dict(first, spec={"holder": "c"}))
        with pytest.raises(side.errors.NotFoundError):
            fake.update_lease("ns", "ghost", first)
        with pytest.raises(ValueError):
            fake.create_lease("ns", {"metadata": {}})
        out.append(fake.get_lease("ns", "l")["spec"])
        return out
    got = both(case)
    assert got["port"] == got["reference"] == [
        {"name": "l", "namespace": "ns", "resourceVersion": "1"},
        ({"name": "l", "namespace": "ns", "resourceVersion": "2"}, {"holder": "b"}),
        {"holder": "b"}]


def test_a_list_gives_the_version_to_watch_from_as_the_references():
    def case(side):
        fake = side.FakeKubeClient(cfg=fresh(side, watch_backlog_events=64))
        before = fake.list_pods_with_rv("ns")
        pod(fake, "seed", namespace="ns")
        pods, rv = fake.list_pods_with_rv("ns")
        fresh_watch = iter(fake.watch_pods("ns", timeout_s=5.0, resource_version=rv))
        fake.patch_pod("ns", "seed", {"metadata": {"annotations": {"z": "1"}}})
        etype, obj = next(fresh_watch)
        for i in range(100):  # the version falls out of the backlog
            pod(fake, f"p-{i}", namespace="ns")
        with pytest.raises(side.errors.GoneError):
            fake.watch_pods("ns", resource_version=rv)
        return before, [p["metadata"]["name"] for p in pods], rv, etype, \
            obj["metadata"]["resourceVersion"]
    got = both(case)
    assert got["port"] == got["reference"] == (([], "0"), ["seed"], "1", "MODIFIED", "2")


# --- the master's answer to an add in a partition ---

def test_an_add_in_a_partition_is_refused_as_the_references(tmp_path):
    """Over HTTP and gRPC (``tests/test_torch_master.py``'s stacks): in a
    write partition the worker cannot make the slave pod, in a read partition
    the master cannot read the pod; both answer 500 with the same body, and
    nothing more is booked. The code ``entry.degraded_check`` holds the card
    to."""
    from test_torch_master import _add, _PortStack, _RefStack
    got = {}
    for name, stack in (("reference", _RefStack(str(tmp_path))),
                        ("port", _PortStack(str(tmp_path), "grpc"))):
        try:
            stack.cluster.add_target_pod("tenant")
            steps = [_add(stack, "tenant", 1)[0], stack.free()]
            for mode in ("writes", "reads"):
                stack.cluster.kube.set_partitioned(True, mode=mode)
                steps += [_add(stack, "tenant", 1), stack.free()]
                stack.cluster.kube.set_partitioned(False)
            got[name] = steps
        finally:
            stack.close()
    assert got["port"] == got["reference"]
    assert [got["port"][i] for i in (0, 1, 3, 5)] == [200, 3, 3, 3]
    assert got["port"][2][0] == got["port"][4][0] == 500


# --- the card's check, on the CPU ---

def test_degraded_check_on_the_cpu():
    """All of entry.degraded_check on the fake host: the healthy round trips
    through the store, a write partition around a remove (4 writes deferred,
    the release deferred, the next release's probe one record of 3, the add
    refused; healed, the flush applies 3 and drops the CAS one), a second
    write partition that a migration's machine meets in the quiesce (its
    two journal persists deferred, the machine paused; healed, it
    succeeds), a read partition around an add, and the costs."""
    report = entry.degraded_check("cpu", repeats=2, cost_iters=5)
    assert report["live"] is None
    flows = report["fake"]
    healthy, writes, reads = flows["healthy"], flows["writes"], flows["reads"]
    assert len(healthy["add_ms"]) == len(healthy["remove_ms"]) == 2
    assert healthy["apihealth"]["api"]["state"] == "healthy"
    assert healthy["registry_lists"] >= 1
    assert writes["deferred"] == 4 and writes["on_disk"] == 4
    assert writes["healthz"] == "ok\napi: down\n"
    assert writes["refused"][0] == 500 and writes["release_attempts"] == [1]
    assert writes["probe"] == {"completed": 0, "pending": 3}
    assert writes["flush"] == {"applied": 3, "lost_cas": 1}
    assert writes["reopened_pending"] == 0 and writes["retried"] == {"completed": 3, "pending": 0}
    assert writes["books"] == [] and len(reads["uuids"]) == 1
    assert reads["stale_reads"] == 1 and reads["refused"][0] == 500 and reads["queued"] == 0
    assert reads["worker_calls"] == 0
    traffic = flows["migration_traffic"]
    assert traffic["put_refused"][0] == 500 and traffic["deferred"] == 2
    assert len(traffic["persist_ms"]) == 2 and traffic["paused_phase"] == "drain"
    assert traffic["applied"] >= 1 and traffic["outcome"] == "succeeded"
    costs = report["costs"]
    assert len(costs["tracked_call_us"]) == len(costs["cached_read_us"]) == 5
    assert len(costs["enqueue_us"]) == 5


# --- the migration machine in an outage ---

ORCHESTRATORS = {"reference": ref_orchestrator, "port": port_orchestrator}


def _paused_at_boundary(side) -> list:
    """The machine's pause, alone: with the verdict down it holds before the
    next phase and journals the pause; two successes release it."""
    health = side.ApiHealth(cfg=fresh(side, **CFG))
    coordinator = ORCHESTRATORS[side.kind].MigrationCoordinator.__new__(
        ORCHESTRATORS[side.kind].MigrationCoordinator)
    coordinator.cfg = fresh(side, **CFG, migrate_poll_interval_s=0.01)
    coordinator.apihealth = health
    coordinator._aborts = set()
    persisted = []
    coordinator._persist = lambda j: persisted.append(dict(j))
    journal = {"id": "mig-x", "phase": "drain"}
    for _ in range(2):
        health.record_failure(side.errors.PartitionError("outage"))
    released = threading.Event()

    def wait():
        coordinator._await_api_healthy(journal)
        released.set()

    thread = threading.Thread(target=wait, daemon=True)
    thread.start()
    time.sleep(0.1)
    held = not released.is_set()
    health.record_success()
    health.record_success()
    out = [held, persisted[0]["paused_for_api"], released.wait(5.0),
           "paused_for_api" in journal, persisted[-1].get("paused_for_api")]
    thread.join(timeout=5.0)
    return out


def test_migration_pauses_at_phase_boundary_unit():
    got = both(_paused_at_boundary)
    assert got["port"] == got["reference"] == [True, True, True, False, None]


def _scan_in_an_outage(side) -> list:
    """A store that cannot answer (no cache, the API down): /migrations
    serves the memory's journals, and resume_interrupted adopts nothing."""

    class RaisingStore:
        def scan_journals(self):
            raise side.errors.PartitionError("no cache, api down")

    coordinator = ORCHESTRATORS[side.kind].MigrationCoordinator(
        side.FakeKubeClient(), None, lambda addr: None, cfg=fresh(side, **CFG),
        store=RaisingStore())
    out = [coordinator.list_migrations(), coordinator.resume_interrupted()]
    with coordinator._lock:
        coordinator._journals["m-1"] = {"id": "m-1", "phase": "drain", "created_at": 1.0}
    return out + [[j["id"] for j in coordinator.list_migrations()],
                  coordinator.get("m-1")["phase"]]


def test_migration_scan_degrades_to_memory_view_during_outage():
    got = both(_scan_in_an_outage)
    assert got["port"] == got["reference"] == [[], [], ["m-1"], "drain"]


def _a_phase_failing_in_an_outage(side, verdict_down: bool) -> str:
    """A phase that fails with the API's outage error: with the verdict still
    healthy the machine rolls back (the race the reference's migrate flavor
    can lose: its partition lands before ApiHealth's verdict); with it down
    by then the machine holds at the boundary and runs the phase again after
    the heal. Returns the outcome, or "held"."""
    mod = ORCHESTRATORS[side.kind]
    health = side.ApiHealth(cfg=fresh(side, **CFG))
    coordinator = mod.MigrationCoordinator(side.FakeKubeClient(), None, lambda addr: None,
                                           cfg=fresh(side, **CFG, migrate_poll_interval_s=0.01),
                                           apihealth=health)
    calls = []

    def drain(journal):
        calls.append(1)
        if len(calls) == 1:
            if verdict_down:  # the verdict goes down before the failure is judged
                for _ in range(2):
                    health.record_failure(side.errors.PartitionError("outage"))
            raise side.errors.PartitionError("the partition")
        raise RuntimeError("stop here")

    coordinator._phase_drain = drain
    coordinator._persist = lambda j: None
    coordinator._rollback = lambda j, reason, outcome="rolled-back": j.update(
        outcome=outcome, phase="done")
    journal = side.journal.new_journal("mig-race", "default", "a", "default", "b")
    journal["phase"] = "drain"
    done = threading.Event()
    thread = threading.Thread(target=lambda: (coordinator._run_traced(journal), done.set()),
                              daemon=True)
    thread.start()
    time.sleep(0.2)
    if not done.is_set():
        outcome = "held" if len(calls) == 1 else f"{len(calls)} calls"
        health.record_success()
        health.record_success()
        done.wait(5.0)
        return outcome
    return journal.get("outcome")


@pytest.mark.parametrize("verdict_down", [False, True], ids=["verdict-healthy", "verdict-down"])
def test_a_phase_failing_in_an_outage_rolls_back_unless_the_verdict_is_down(verdict_down):
    got = both(_a_phase_failing_in_an_outage, verdict_down)
    assert got["port"] == got["reference"] == ("held" if verdict_down else "rolled-back")


def _a_phase_meeting_the_partition_first(side):
    """A phase whose calls fail through the health-tracked client, each
    recording its failure: the first meets a healthy verdict (a streak of 1
    under the threshold of 2). Returns the outcome, or the held machine's
    ("held", the phase's runs, its journaled pause)."""
    mod = ORCHESTRATORS[side.kind]
    health = side.ApiHealth(cfg=fresh(side, **CFG))
    coordinator = mod.MigrationCoordinator(side.FakeKubeClient(), None, lambda addr: None,
                                           cfg=fresh(side, **CFG, migrate_poll_interval_s=0.01),
                                           apihealth=health)
    partitioned, calls = [True], []

    def drain(journal):
        calls.append(1)
        if partitioned[0]:
            exc = side.errors.PartitionError("the partition")
            health.record_failure(exc)
            raise exc
        raise RuntimeError("stop here")

    coordinator._phase_drain = drain
    coordinator._persist = lambda j: None
    coordinator._rollback = lambda j, reason, outcome="rolled-back": j.update(
        outcome=outcome, phase="done")
    journal = side.journal.new_journal("mig-first", "default", "a", "default", "b")
    journal["phase"] = "drain"
    done = threading.Event()
    thread = threading.Thread(target=lambda: (coordinator._run_traced(journal), done.set()),
                              daemon=True)
    thread.start()
    deadline = time.monotonic() + 10.0
    while not (done.is_set() or journal.get("paused_for_api")) \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    if done.is_set():
        return journal.get("outcome")
    out = ("held", len(calls), journal.get("paused_for_api"))
    partitioned[0] = False
    health.record_success()
    health.record_success()
    done.wait(5.0)
    return out


def test_a_phase_meeting_the_partition_before_the_verdict_holds():
    """The port's fix of the reference's race (ROADMAP §3): the machine
    holds on the API's failure streak under the verdict's threshold, runs the
    phase again, and its second failure flips the verdict and pauses it;
    the reference's rolls back in the outage."""
    got = both(_a_phase_meeting_the_partition_first)
    assert got == {"reference": "rolled-back", "port": ("held", 2, True)}


def test_a_failure_that_is_not_the_apis_still_rolls_back_under_a_short_streak():
    """The hold is bounded: a phase that fails again and again while the
    API's streak stays under the verdict (one blip; the failure has another
    cause) rolls back after the threshold's count of extra runs."""
    side = SIDES["port"]
    health = side.ApiHealth(cfg=fresh(side, **CFG))
    coordinator = port_orchestrator.MigrationCoordinator(
        side.FakeKubeClient(), None, lambda addr: None,
        cfg=fresh(side, **CFG, migrate_poll_interval_s=0.01), apihealth=health)
    health.record_failure(side.errors.PartitionError("one blip"))
    calls = []

    def drain(journal):
        calls.append(1)
        raise RuntimeError("a worker's refusal")

    coordinator._phase_drain = drain
    coordinator._persist = lambda j: None
    coordinator._rollback = lambda j, reason, outcome="rolled-back": j.update(
        outcome=outcome, phase="done", error=reason)
    journal = side.journal.new_journal("mig-bounded", "default", "a", "default", "b")
    journal["phase"] = "drain"
    coordinator._run_traced(journal)
    assert (journal["outcome"], journal["error"], len(calls)) == \
        ("rolled-back", "a worker's refusal", 3)
    assert health.ok()


# --- chaos invariant 14 ---

OUTAGE_SEEDS = [101, 202, 303]
FLAVORS = ["mount", "migrate", "heal", "recovery"]


@pytest.mark.parametrize("seed", OUTAGE_SEEDS)
@pytest.mark.parametrize("flavor", FLAVORS)
def test_invariant14_api_outage(tmp_path, seed, flavor):
    from gpumounter_tpu_torch.testing.chaos import ChaosHarness
    with ChaosHarness(str(tmp_path), seed=seed) as harness:
        out = harness.run_api_outage_scenario(flavor=flavor)
        schedule = harness.schedule
    assert out["apihealth"]["state"] == "healthy"
    assert out["queue"]["pending"] == 0
    if flavor == "migrate":
        held = [line for line in schedule if " held in phase " in line]
        holding = [line for line in schedule if " holding at phase " in line]
        assert len(held) == 1 and len(holding) == 1 and "paused_for_api=True" in holding[0]
        assert any(line.endswith("-> succeeded") for line in schedule), schedule


def test_invariant14_negative_control_detects_broken_replay(tmp_path):
    from gpumounter_tpu_torch.testing.chaos import ChaosHarness, InvariantViolation
    with ChaosHarness(str(tmp_path), seed=OUTAGE_SEEDS[0]) as harness:
        with pytest.raises(InvariantViolation, match="divergence"):
            harness.run_api_outage_scenario(flavor="mount", replay_enabled=False)


def test_the_migrate_outage_meets_the_machine_in_a_seeded_phase(tmp_path):
    """The port's migrate flavor holds the machine inside a phase drawn from
    the seed while the partition lands, and releases it under a healthy
    verdict (ROADMAP §3): the phase is the seed's draw, the pause is
    journaled at it, and the same seed draws it again."""
    from gpumounter_tpu_torch.testing.chaos import ChaosHarness
    phases = []
    for run in range(2):
        with ChaosHarness(str(tmp_path / str(run)), seed=202) as harness:
            harness.run_api_outage_scenario(flavor="migrate")
            held = next(line for line in harness.schedule if " held in phase " in line)
            holding = next(line for line in harness.schedule if " holding at phase " in line)
            phases.append((held.rsplit(" ", 1)[1], holding.split(" holding at phase ")[1]
                           .split(" ")[0]))
    assert phases[0] == phases[1]
    held_phase, paused_phase = phases[0]
    assert held_phase in ChaosHarness.OUTAGE_MIGRATE_PHASES and paused_phase == held_phase


@pytest.mark.parametrize("seed", OUTAGE_SEEDS)
def test_invariant14_detects_a_machine_that_rolls_back_before_the_verdict(tmp_path, seed):
    """The migrate flavor's control: with the hold on the API's early
    streak taken out (the reference's rule, the verdict alone), the machine
    meets the partition under a healthy verdict, rolls back in the outage,
    and the scenario names it."""
    from gpumounter_tpu_torch.testing.chaos import ChaosHarness, InvariantViolation
    with ChaosHarness(str(tmp_path), seed=seed) as harness:
        harness.app.apihealth.failing = lambda: False
        with pytest.raises(InvariantViolation, match="terminal during the outage"):
            harness.run_api_outage_scenario(flavor="migrate")
