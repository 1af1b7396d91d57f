"""The port's base chaos harness (``gpumounter_tpu_torch/testing/chaos.py``).

The counterparts of ``tests/test_chaos.py``'s controls run on both
packages' harnesses, and what each found must be the same: the disabled
rollback is detected (an ownerless grant, with the seed in the message), the
slice's admission failpoint fails clean, and the skipped slice rollback
leaves one host's GPU mounted and booked. Then the port's seeded mount,
elastic and migrate scenarios at three seeds, whose invariants 1-6 must hold
(converged, as the reference's, through the declared intents and the
migrations' journals), each drawing the reference's decisions on the same
seed, and the reproducibility of its schedule; invariants 4 and 6 name a
stranded journal and a terminal one without its record, and invariant 13
(the tenants' disruption windows) holds on a migration under a tenant and
names an unattributed window. Then invariants 7 (the channel pool's
books), 15 (the lock order) and 22 (the watch store against a fresh list,
with its poisoned-index control) on both harnesses, and invariant 9 (one
owner a shard) on the reference's seeds, its decisions the reference's.
"""

from __future__ import annotations

import shutil
import time

import pytest
from torch_durability import short_root
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.faults import failpoints as ref_failpoints
from gpumounter_tpu.master.slice_ops import SliceError as RefSliceError
from gpumounter_tpu.master.slice_ops import SliceTarget as RefTarget
from gpumounter_tpu.migrate import journal as ref_journal
from gpumounter_tpu.testing import chaos as ref_chaos
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.master.slice_ops import SliceError, SliceTarget
from gpumounter_tpu_torch.migrate import journal
from gpumounter_tpu_torch.testing import chaos
from gpumounter_tpu_torch.testing.chaos import NODE_A, NODE_B, ChaosHarness, InvariantViolation

SEEDS = [7, 1337, 20260803]

#: (harness module, failpoints, SliceTarget, SliceError, the mount coordinator)
SIDES = {
    "reference": (ref_chaos, ref_failpoints, RefTarget, RefSliceError,
                  lambda h: h._coordinator()),
    "port": (chaos, failpoints, SliceTarget, SliceError, lambda h: h.coordinator()),
}


def _control(name, root, seed, pods, schedule, n):
    """Arm `schedule`, mount a slice of `n` single mounts into `pods`; what
    the mount raised, the pods holding a GPU after, and the invariants'
    verdict (their first violation's kind)."""
    mod, fp, target, slice_error, coordinator = SIDES[name]
    with mod.ChaosHarness(root, seed=seed) as h:
        for pod, node in pods:
            h.add_pod(pod, node)
        armed = {k.replace("addgpu", "addtpu") if name == "reference" else k: v
                 for k, v in schedule.items()}
        raised = None
        with fp.armed(armed):
            try:
                coordinator(h).mount_slice([target(namespace="default", pod=p) for p, _ in pods],
                                           n, entire=False)
            except (slice_error, fp.FailpointError) as exc:
                raised = type(exc).__name__
        held = h.held_chips() if name == "reference" else h.held_gpus()
        try:
            h.check_invariants()
            verdict = "held"
        except mod.InvariantViolation as exc:
            message = str(exc)
            verdict = (message.split("\n- ")[1].split(":")[0], f"seed={seed}" in message)
    return raised, sorted(p for (_, p), uuids in held.items() if uuids), verdict


CONTROLS = {
    "the disabled rollback is detected": (
        [("victim", NODE_A)], {"worker.addgpu.rollback.skip": "return(true)",
                               "worker.mount.mknod": "1*pass->1*error(chaos mknod)"}, 2,
        ("SliceError", ["victim"], ("ownerless grant", True))),
    "the slice's admission failpoint fails clean": (
        [("adm", NODE_A)], {"master.slice.mount": "1*error(chaos admission)"}, 1,
        ("FailpointError", [], "held")),
    "the skipped slice rollback leaves one host mounted": (
        [("sl-a", NODE_A), ("sl-b", NODE_B)],
        {"master.slice.rollback.skip": "return(true)",
         "worker.mount.mknod": "1*pass->1*error(chaos mknod)"}, 1,
        None),
}


@pytest.mark.parametrize("case", list(CONTROLS))
def test_a_control_ends_as_the_references(tmp_path, case):
    pods, schedule, n, want = CONTROLS[case]
    got = {name: _control(name, str(tmp_path / name), 1 + list(CONTROLS).index(case), pods,
                          schedule, n) for name in SIDES}
    if want is None:  # which host fails its mknod is a race: one of the two survives
        for raised, survivors, verdict in got.values():
            assert (raised, len(survivors), verdict) == ("SliceError", 1, "held")
    else:
        assert got["port"] == got["reference"] == want


def _draws(schedule) -> list[str]:
    """The seeded draws of a schedule: the faults armed (their actions), the
    intents declared and the GPUs killed."""
    return ["kill" if line.startswith("kill chip") else line.split("(")[0]
            for line in schedule if line.startswith(("arm ", "intent ", "kill chip"))]


def _reference_draws(scenario: str, seed: int, **kwargs) -> list[str]:
    root = short_root()
    try:
        with ref_chaos.ChaosHarness(root, seed) as h:
            getattr(h, scenario)(**kwargs)
            h.check_invariants()
            return _draws(h.schedule)
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_mount_chaos(tmp_path, seed):
    """Adds, removes and reconciles of pods with intents; the faults' deaths
    converged through the intents, as the reference's; the reference's
    draws."""
    with ChaosHarness(str(tmp_path), seed) as h:
        h.run_mount_scenario(n_ops=8)
        h.check_invariants()
        assert any(line.startswith("arm ") for line in h.schedule), h.schedule
        assert any(line.startswith("reconcile ") for line in h.schedule), h.schedule
        assert _draws(h.schedule) == _reference_draws("run_mount_scenario", seed,
                                                              n_ops=8)


@pytest.mark.parametrize("seed", SEEDS)
def test_elastic_chaos(tmp_path, seed):
    """GPU deaths healed and intents converged under FAULTS_ELASTIC; the
    reference's draws on the same seed."""
    with ChaosHarness(str(tmp_path), seed) as h:
        h.run_elastic_scenario(n_ops=8)
        h.check_invariants()
        assert _draws(h.schedule) == _reference_draws("run_elastic_scenario", seed,
                                                              n_ops=8)


@pytest.mark.parametrize("seed", SEEDS)
def test_migrate_chaos(tmp_path, seed):
    """Migrations crashed at their boundaries end terminal through
    resume_interrupted (invariant 4), each with its record (6); the
    reference's draws on the same seed."""
    with ChaosHarness(str(tmp_path), seed) as h:
        h.run_migrate_scenario(n_migrations=2)
        h.check_invariants()
        journals = h.app.migrations.list_migrations()
        assert journals and all(j["phase"] == "done" for j in journals)
        assert _draws(h.schedule) == _reference_draws("run_migrate_scenario", seed,
                                                              n_migrations=2)


def test_the_elastic_and_migrate_pools_are_the_references():
    assert chaos.FAULTS_ELASTIC == ref_chaos.FAULTS_ELASTIC
    assert chaos.FAULTS_MIGRATE == ref_chaos.FAULTS_MIGRATE


@pytest.mark.parametrize("name", list(SIDES))
def test_a_stranded_journal_and_a_recordless_one_are_violations(tmp_path, name):
    """Invariants 4 and 6 have teeth, on both harnesses: a journal left in
    flight and a terminal one with no ``migrate`` record are named."""
    mod = ref_chaos if name == "reference" else chaos
    jmod = ref_journal if name == "reference" else journal
    root = short_root() if name == "reference" else str(tmp_path)
    try:
        with mod.ChaosHarness(root, seed=4) as h:
            h.add_pod("src", mod.NODE_A)
            h.add_pod("done", mod.NODE_A)
            stranded = jmod.new_journal("mig-stranded", "default", "src", "default", "x")
            finished = jmod.new_journal("mig-quiet", "default", "done", "default", "x")
            finished.update(phase="done", outcome="succeeded")
            for pod, j in (("src", stranded), ("done", finished)):
                h.cluster.kube.patch_pod("default", pod, {"metadata": {"annotations": {
                    jmod.ANNOT_JOURNAL: jmod.dump(j)}}})
            with pytest.raises(mod.InvariantViolation) as err:
                h.check_invariants()
    finally:
        if name == "reference":
            shutil.rmtree(root, ignore_errors=True)
    message = str(err.value)
    assert "journal mig-stranded not terminal/clean: phase=quiesce outcome=None" in message
    assert "migration mig-quiet finished (succeeded) but left no terminal audit record" \
        in message and "seed=4" in message


def test_invariant_13_attributes_a_tenants_migration_downtime(tmp_path):
    """A live migration under a tenant on the port's telemetry and watchers:
    its migration window carries the journal's trace, which resolves, and
    invariant 13 holds; a fabricated unattributed window is named (the
    reference's ``test_chaos_invariant_13_attributes_tenant_downtime``)."""
    from gpumounter_tpu_torch.obs import trace
    with ChaosHarness(str(tmp_path), seed=5) as h:
        h.add_pod("src", NODE_A)
        h.add_pod("dst", NODE_B)
        h.coordinator().mount_slice([SliceTarget(namespace="default", pod="src")], 2,
                                    entire=False)
        sim = h.attach_tenant("default", "src", extra_pods=(("default", "dst"),))
        time.sleep(0.1)
        begun = h.app.migrations.begin("default", "src", "default", "dst")
        final = h.app.migrations.wait(begun["id"], timeout_s=60.0)
        assert final and final["outcome"] == "succeeded", final
        h.converge()
        h.check_invariants()
        windows = [w for w in sim.telemetry.snapshot()["disruption"]["windows"]
                   if w["cause"] == "migration"]
        assert windows and all(w["trace_id"] == begun["trace_id"] for w in windows)
        assert trace.trace_payload(begun["trace_id"]) is not None
        assert final["quiesced"] and final["resumed"]
        sim.telemetry.begin_disruption("heal", trace_id="")
        sim.telemetry.end_disruption("heal")
        with pytest.raises(InvariantViolation, match="without a control-plane"):
            h.check_invariants()


def test_the_schedule_replays_from_its_seed(tmp_path):
    def decisions(root):
        with ChaosHarness(root, 42) as h:
            h.run_mount_scenario(n_ops=6)
            return [line for line in h.schedule if line.startswith("arm ")]

    assert decisions(str(tmp_path / "a")) == decisions(str(tmp_path / "b"))


def test_the_pool_is_the_references_without_its_crash_terms():
    """The pool was the reference's less its two crash terms until the
    ledger's replay came to converge what they leave; now it is the
    reference's whole, and without its crash terms it is that pool still."""
    assert chaos.FAULTS_COMMON == ref_chaos.FAULTS_COMMON
    crash = [f for f in chaos.FAULTS_COMMON if "crash" in f[1]]
    assert [name for name, _ in crash] == ["worker.mount.before_grant",
                                           "worker.mount.after_grant"]
    assert [f for f in chaos.FAULTS_COMMON if f not in crash] == \
        [f for f in ref_chaos.FAULTS_COMMON if "crash" not in f[1]]


def test_an_open_span_and_a_traceless_record_are_violations(tmp_path):
    """Invariants 5 and 6 have teeth: a span left open and an audit record
    with no outcome and no trace id are each named, with the seed."""
    from gpumounter_tpu_torch.obs import audit, trace
    with ChaosHarness(str(tmp_path), seed=5) as h:
        trace.TRACER._open_add("dangling", "never.closed")
        audit.AUDIT.record("bare.op", trace_id="")
        with pytest.raises(InvariantViolation) as err:
            h.check_invariants()
    message = str(err.value)
    assert "seed=5" in message and "never.closed" in message
    assert "audit record without outcome" in message and "without trace id" in message


# --- invariants 7, 15 and 22 ---


def _watch_round(name, root, seed, poison=False, **sizes):
    """The watch-store scenario on one package's harness: its rounds, its
    intent and journal index sizes, its relists, and the invariants' verdict
    (the first violation's text when they fail)."""
    mod = ref_chaos if name == "reference" else chaos
    with mod.ChaosHarness(root, seed=seed) as h:
        out = h.run_watch_store_scenario(**sizes)
        if poison:
            h.poison_watch_index()
        try:
            h.check_invariants()
            verdict = "held"
        except mod.InvariantViolation as exc:
            verdict = str(exc)
    indexes = out["payload"]["indexes"]
    return out["rounds"], indexes["intents"], indexes["journals"], out["relists_total"], verdict


@pytest.mark.parametrize("seed", SEEDS)
def test_watch_store_chaos_as_the_references(tmp_path, seed):
    """Invariant 22 holds on both harnesses after the storm (a real 410:
    at least three relists), the restart and the churn, in the same seeded
    order and with the same intent and journal populations."""
    got = {name: _watch_round(name, str(tmp_path / name), seed) for name in SIDES}
    for rounds, _, _, relists, verdict in got.values():
        assert verdict == "held"
        assert set(rounds) == {"storm", "restart", "steady"}
        assert relists >= 3
    assert got["port"][:3] == got["reference"][:3]


def test_the_poisoned_watch_index_is_flagged_as_the_reference_flags_it(tmp_path):
    got = {name: _watch_round(name, str(tmp_path / name), 3, poison=True,
                              churn_per_round=10, storm_events=80) for name in SIDES}
    for *_, verdict in got.values():
        assert "invariant 22" in verdict and "intent index diverges" in verdict
        assert "seed=3" in verdict


def test_the_channel_pools_books_hold_under_chaos_as_the_references(tmp_path):
    """Invariant 7 after the mount scenario: every dialed channel is live or
    closed, on both harnesses, and neither pool holds more live channels
    than its two workers."""
    stats = {}
    for name in SIDES:
        mod = ref_chaos if name == "reference" else chaos
        with mod.ChaosHarness(str(tmp_path / name), seed=7) as h:
            h.run_mount_scenario(n_ops=6)
            h.check_invariants()
            stats[name] = h.channel_pool.stats()
    for books in stats.values():  # the scenarios' draws differ: not the counts
        assert books["dialed"] == books["live"] + books["closed"]
        assert 1 <= books["live"] <= 2


def test_a_channel_off_the_books_is_a_violation(tmp_path):
    """Invariant 7 has teeth: a channel dialed outside the books, and more
    live channels than workers, are each named. Invariant 8's collections,
    which run before 7, hold one live channel a worker: three more make
    five for two workers."""
    with ChaosHarness(str(tmp_path), seed=11) as h:
        h.channel_pool._dialed += 1
        with pytest.raises(InvariantViolation) as err:
            h.check_invariants()
        assert "channel-pool books off" in str(err.value)
        h.channel_pool._dialed -= 1
        assert h.channel_pool.stats()["live"] == 2  # invariant 8's, one a worker
        for i in range(3):
            h.channel_pool.channel(f"127.0.0.1:{1 + i}")
        with pytest.raises(InvariantViolation) as err:
            h.check_invariants()
        assert "channel leak: 5 live channel(s) for 2 worker(s)" in str(err.value)


@pytest.mark.parametrize("name", list(SIDES))
def test_a_reversed_acquisition_is_a_lock_order_violation(tmp_path, name):
    """Invariant 15 on either harness: two locks taken in both orders make
    a cycle, named with its path. The global recorder is cleared after, so
    the seeded cycle fails no later test."""
    from gpumounter_tpu.utils import locks as ref_locks
    from gpumounter_tpu_torch.utils import locks as port_locks
    mod, lk = (ref_chaos, ref_locks) if name == "reference" else (chaos, port_locks)
    a, b = lk.OrderedLock("fixture.a"), lk.OrderedLock("fixture.b")
    with mod.ChaosHarness(str(tmp_path), seed=13) as h:
        try:
            with a, b:
                pass
            with b, a:
                pass
            with pytest.raises(mod.InvariantViolation) as err:
                h.check_invariants()
        finally:
            lk.RECORDER.clear()
    assert "lock-order" in str(err.value) and "fixture.a" in str(err.value)


def test_the_runs_lock_order_is_acyclic_and_names_the_ports_sites(tmp_path):
    """A mount scenario records real nestings of the port's named locks, and
    they form no cycle."""
    from gpumounter_tpu_torch.utils import locks as port_locks
    with ChaosHarness(str(tmp_path), seed=1337) as h:
        h.run_mount_scenario(n_ops=4)
        h.check_invariants()
    edges = port_locks.RECORDER.edges()
    assert edges and port_locks.find_cycle(edges) is None


# --- invariant 9: one owner a shard ---


def _decisions(schedule):
    return [step.split("->")[0].split("(")[0].strip() for step in schedule]


@pytest.mark.parametrize("seed", SEEDS)
def test_shard_lease_chaos(seed):
    """Crashes, restarts and takeovers of master replicas: no shard is ever
    claimed by two views, every shard ends owned, and the port's scenario
    makes the reference's decisions on the same seed."""
    from gpumounter_tpu.testing.chaos import run_shard_scenario as ref_run
    schedule = chaos.run_shard_scenario(seed)
    assert any("converged" in step for step in schedule)
    ops = [d for d in _decisions(schedule) if not d.startswith("converged")]
    ref_ops = [d for d in _decisions(ref_run(seed)) if not d.startswith("converged")]
    assert ops == ref_ops


def test_shard_scenario_is_reproducible():
    assert _decisions(chaos.run_shard_scenario(99)) == _decisions(chaos.run_shard_scenario(99))


# --- invariants 8 and 16: the fleet rollup and the trace assembly ---


def _drive_clean_ops(name, h, pod, n=2):
    """A few fault-free adds and removes of one GPU on NODE_A, each under a
    chaos.<op> root span (fault_p 0: captured whenever it succeeds), on
    either package's harness."""
    target = SIDES[name][2]
    h.add_pod(pod, NODE_A)
    for _ in range(n):
        coordinator = h._coordinator() if name == "reference" else h.coordinator()
        args = ([],) if name == "reference" else ()
        h._op(*args, f"add 1 to {pod}",
              lambda c=coordinator: c.mount_slice([target(namespace="default", pod=pod)], 1,
                                                  entire=False),
              fault_p=0.0, capture_trace=True)
        held = ([c.uuid for c in h.probe("default", pod)] if name == "reference"
                else sorted(h.held_gpus()[("default", pod)]))
        if not held:
            continue

        def _remove(uuid=held[0]):
            if name == "reference":
                with h._client_for_node(NODE_A) as client:
                    client.remove_tpu(pod, "default", [uuid], force=True)
            else:
                with h.client_for_node(NODE_A) as client:
                    client.remove_gpu(pod, "default", [uuid], force=True)

        h._op(*args, f"remove {held[0]} from {pod}", _remove, fault_p=0.0, capture_trace=True)


def _assembled(name, root, seed, drop=False):
    """The clean ops on one package's harness: the ops captured, the phases
    of the first one's assembled tree, and the invariants' verdict (after
    the negative control's drop, with `drop`)."""
    from gpumounter_tpu.obs import assembly as ref_assembly
    from gpumounter_tpu_torch.obs import assembly
    mod = ref_chaos if name == "reference" else chaos
    with mod.ChaosHarness(root, seed=seed) as h:
        _drive_clean_ops(name, h, "tr-pod", n=1 if drop else 2)
        h.check_invariants()  # clean before any corruption
        tree = (ref_assembly if name == "reference" else assembly).assemble(
            h.traced_ops[0]["trace"])
        verdict = "held"
        if drop:
            assert h.drop_worker_spans() > 0
            try:
                h.check_invariants()
            except mod.InvariantViolation as exc:
                verdict = str(exc)
    return [op["op"].split(" ")[0] for op in h.traced_ops], tree, verdict


@pytest.mark.parametrize("seed", SEEDS)
def test_every_clean_op_assembles_complete_as_the_references(tmp_path, seed):
    """Invariant 16 on a population that is never empty: each clean add and
    remove assembles complete on both harnesses, its phases sum to its wall
    time, and the first add's tree carries the same phases in both
    packages (the worker's grant and mknod among them)."""
    got = {name: _assembled(name, str(tmp_path / name), seed) for name in SIDES}
    (ops, tree, verdict), (ref_ops, ref_tree, ref_verdict) = got["port"], got["reference"]
    assert verdict == ref_verdict == "held"
    assert ops == ref_ops == ["add", "remove", "add", "remove"]
    assert tree["complete"] and ref_tree["complete"]
    assert {"cgroup_grant", "mknod"} <= set(tree["phases"])
    assert set(tree["phases"]) == set(ref_tree["phases"])
    assert abs(sum(tree["phases"].values()) - tree["wall_ms"]) <= max(2.0,
                                                                      0.05 * tree["wall_ms"])


def test_dropped_worker_spans_are_an_incomplete_assembly_as_in_the_reference(tmp_path):
    """16's negative control: the worker spans dropped from the ring and the
    remote store, every traced op assembles INCOMPLETE, with the seed."""
    for name in SIDES:
        _, _, verdict = _assembled(name, str(tmp_path / name), 5, drop=True)
        assert "INCOMPLETE" in verdict and "missing their worker half" in verdict, name
        assert "seed=5" in verdict


@pytest.mark.parametrize("seed", SEEDS)
def test_two_fresh_collectors_agree_as_the_references(tmp_path, seed):
    """Invariant 8 after the mount scenario on both harnesses: two fresh
    collectors see both workers over CollectTelemetry, the totals are the
    nodes' sums, and a third collector of the port's reads the same node
    counts again."""
    from gpumounter_tpu.obs.fleet import FleetCollector as RefCollector
    from gpumounter_tpu_torch.obs.fleet import FleetCollector
    for name in SIDES:
        mod = ref_chaos if name == "reference" else chaos
        with mod.ChaosHarness(str(tmp_path / name), seed=seed) as h:
            h.run_mount_scenario(n_ops=6)
            h.check_invariants()
            collector = RefCollector if name == "reference" else FleetCollector
            a, b = (collector(h.app.registry, h.app._client_factory, cfg=h.cfg).collect_once()
                    for _ in range(2))
        assert set(a["nodes"]) == set(b["nodes"]) == {NODE_A, NODE_B}, name
        assert {e["mode"] for e in a["nodes"].values()} == {"rpc"}, name
        for rollup in (a, b):
            assert rollup["fleet"]["mount_count"] == sum(
                e["mount"]["count"] for e in rollup["nodes"].values())
        assert {n: e["mount"]["count"] for n, e in a["nodes"].items()} == \
            {n: e["mount"]["count"] for n, e in b["nodes"].items()}


def test_a_node_counted_twice_is_an_invariant_8_violation(tmp_path, monkeypatch):
    """Invariant 8 has teeth: a rollup whose total doubles a node is named,
    with the seed."""
    from gpumounter_tpu_torch.obs import fleet
    real = fleet.FleetCollector.payload

    def doubled(self, max_age_s=None):
        out = real(self, max_age_s)
        out["fleet"]["mount_count"] += next(iter(out["nodes"].values()))["mount"]["count"] + 1
        return out

    with ChaosHarness(str(tmp_path), seed=7) as h:
        _drive_clean_ops("port", h, "dbl-pod", n=1)
        monkeypatch.setattr(fleet.FleetCollector, "payload", doubled)
        with pytest.raises(InvariantViolation) as err:
            h.check_invariants()
    assert "a node counted twice or dropped" in str(err.value) and "seed=7" in str(err.value)


# --- invariant 20: a gray failure, scored and quarantined ---

#: 4 nodes: a healthy herd of 3 keeps the fleet's median a healthy one
GRAY_NODES = {NODE_A: 4, NODE_B: 4, "chaos-c": 4, "chaos-d": 4}


@pytest.mark.parametrize("seed", SEEDS)
def test_gray_failure_chaos(tmp_path, seed):
    """NODE_B limps under the reference's seeded GRAY_FAULTS while the rest
    serve clean traffic: the app's health plane quarantines exactly it, and
    invariant 20 holds (every quarantine flight-attributed to a signal, no
    false one)."""
    assert ChaosHarness.GRAY_FAULTS == ref_chaos.ChaosHarness.GRAY_FAULTS
    with ChaosHarness(str(tmp_path), seed, nodes=dict(GRAY_NODES)) as h:
        out = h.run_gray_scenario()
        h.check_invariants()
    assert out["states"][NODE_B] == "quarantined" and out["passes"] == 4
    assert [s for n, s in out["states"].items() if n != NODE_B] == ["healthy"] * 3


@pytest.mark.parametrize("seed", SEEDS)
def test_gray_chaos_healthy_fleet_no_false_quarantine(tmp_path, seed):
    """The same scenario with no node degraded ends with no quarantine."""
    with ChaosHarness(str(tmp_path), seed, nodes=dict(GRAY_NODES)) as h:
        out = h.run_gray_scenario(limping=(), n_rounds=3)
        h.check_invariants()
    assert all(s != "quarantined" for s in out["states"].values()), out["states"]


def test_gray_chaos_detects_disabled_scorer(tmp_path):
    """The negative control: the scorer off while NODE_B limps; invariant 20
    names the missed detection, with the seed."""
    with ChaosHarness(str(tmp_path), seed=7, nodes=dict(GRAY_NODES)) as h:
        h.run_gray_scenario(disable_scorer=True)
        with pytest.raises(InvariantViolation) as err:
            h.check_invariants()
    assert "gray failure NOT detected" in str(err.value)
    assert "seed=7" in str(err.value)


@pytest.mark.parametrize("node,quarantined_by", [
    ("healthy, one stall", {"cumulative": True, "round": False}),
    ("limping", {"cumulative": True, "round": True})])
def test_each_gray_pass_scores_its_own_round_where_the_reference_scores_them_all(
        node, quarantined_by):
    """The difference on purpose: the port's gray scenario scores each pass
    over the round just run, the reference's over every sample since the
    scenario began. Three rounds of 3 mounts, a herd of 3 at 49 ms and the
    floor of 150 ms (bar 199 ms): a healthy node that stalled once to 256 ms
    in the first round (as a loaded host stalled one) is quarantined by the
    cumulative window, whose p95 stays 256 ms, and not by the round's; a
    limping node whose every round carries the 200 ms mknod delay is
    quarantined by both."""
    import dataclasses
    import types

    from gpumounter_tpu_torch.config import Config
    from gpumounter_tpu_torch.health import HealthPlane

    rounds = {"healthy, one stall": [[49.0, 256.0, 49.0], [49.0] * 3, [49.0] * 3],
              "limping": [[251.0, 60.0, 49.0], [49.0, 255.0, 49.0], [49.0, 49.0, 262.0]]}[node]
    harness = types.SimpleNamespace(dead_nodes=set())

    def quarantined(window: str) -> bool:
        cfg = dataclasses.replace(Config(), health_enabled=True, health_min_samples=3,
                                  health_p95_multiplier=3.0,
                                  health_p95_floor_ms=ChaosHarness.GRAY_P95_FLOOR_MS,
                                  health_suspect_strikes=2, health_quarantine_strikes=3,
                                  health_clear_passes=2)
        plane = HealthPlane(cfg)
        seen: list[float] = []
        for samples in rounds:
            seen += samples
            probe = seen if window == "cumulative" else samples
            by_node = {f"h-{j}": [49.0] * len(probe) for j in range(3)}
            by_node["probe"] = list(probe)
            plane.observe(ChaosHarness._gray_entries(harness, by_node,
                                                     {n: 0 for n in by_node}))
        return plane.payload()["nodes"]["probe"]["state"] == "quarantined"

    assert {w: quarantined(w) for w in quarantined_by} == quarantined_by


def test_the_gray_p95_floor_clears_a_loaded_hosts_stall_and_stays_under_the_limp():
    """The difference on purpose: the port's gray scenario scores with a p95
    floor of 150 ms, the reference's with 20 ms. With a healthy herd at a 10
    ms p95, a healthy node that stalled once to 45 ms (a loaded host's
    hiccup) is an outlier under 20 ms (bar 30 ms) and not under 150 ms (bar
    160 ms); a limping node whose p95 carries the injected 200 ms mknod delay
    (210 ms) is one under both, so its quarantine is kept."""
    import dataclasses

    from gpumounter_tpu_torch.config import Config
    from gpumounter_tpu_torch.health import HealthPlane

    assert ChaosHarness.GRAY_P95_FLOOR_MS == 150.0
    herd = {n: {"mount": {"count": 6, "p95_ms": 10.0, "success": 6, "error": 0},
                "breaker": "closed"} for n in ("h-0", "h-1", "h-2")}

    def signals(floor, p95):
        cfg = dataclasses.replace(Config(), health_enabled=True, health_min_samples=3,
                                  health_p95_multiplier=3.0, health_p95_floor_ms=floor,
                                  health_suspect_strikes=1)
        plane = HealthPlane(cfg)
        plane.observe(dict(herd, probe={"mount": {"count": 6, "p95_ms": p95, "success": 6,
                                                  "error": 0}, "breaker": "closed"}))
        return plane.payload()["nodes"]["probe"]["signals"]

    assert signals(20.0, 45.0) and not signals(ChaosHarness.GRAY_P95_FLOOR_MS, 45.0)
    assert signals(20.0, 210.0) and signals(ChaosHarness.GRAY_P95_FLOOR_MS, 210.0)


# --- invariant 17: the capacity plane against the scheduler's books ---


@pytest.mark.parametrize("name", list(SIDES))
def test_capacity_invariant_detects_withheld_unmount(tmp_path, name):
    """Invariant 17 holds after a clean mount on both harnesses, and a held
    GPU's kubelet claim erased without its unmount (a lost unmount) is named
    as capacity divergence, with the seed. The positive side runs in every
    check_invariants of this file's scenarios."""
    mod, _, target, _, coordinator = SIDES[name]
    root = short_root() if name == "reference" else str(tmp_path)
    try:
        with mod.ChaosHarness(root, seed=3) as h:
            h.add_pod("cap-pod", mod.NODE_A)
            coordinator(h).mount_slice([target(namespace="default", pod="cap-pod")], 1,
                                       entire=False)
            h.check_invariants()
            assert h.withhold_unmount(mod.NODE_A) is not None
            with pytest.raises(mod.InvariantViolation) as err:
                h.check_invariants()
    finally:
        if name == "reference":
            shutil.rmtree(root, ignore_errors=True)
    message = str(err.value)
    assert "capacity divergence on chaos-a: reported free" in message and "seed=3" in message


# --- invariant 19: fractional shares, books == policy == ledger ---


def test_the_share_pool_and_tenants_are_the_references():
    assert ChaosHarness.FAULTS_SHARE == ref_chaos.ChaosHarness.FAULTS_SHARE
    assert ChaosHarness.SHARE_TENANTS == ref_chaos.ChaosHarness.SHARE_TENANTS


@pytest.mark.parametrize("seed", SEEDS)
def test_share_chaos(tmp_path, seed):
    """Policy-carrying mounts over gRPC, re-grants, releases and worker deaths
    with the replay, then invariant 19 (books == policy entries == ledger
    share records, the throttle alike in the engine and the device program)
    and invariant 17; the reference's draws on the same seed."""
    with ChaosHarness(str(tmp_path), seed) as h:
        h.run_share_scenario()
        h.check_invariants()
        assert h.app.shares.books(), h.schedule
        assert _draws(h.schedule) == _reference_draws("run_share_scenario", seed)


def test_share_chaos_detects_disabled_enforcement(tmp_path):
    """The engine a bookkeeper (admits past an exhausted budget): the
    throttle half of invariant 19 names the divergence from the device
    program."""
    with ChaosHarness(str(tmp_path), seed=7) as h:
        h.run_share_scenario(n_ops=6)
        h.check_invariants()
        h.disable_enforcement()
        with pytest.raises(InvariantViolation) as err:
            h.check_invariants()
    assert "throttle divergence" in str(err.value) and "seed=7" in str(err.value)
    from gpumounter_tpu_torch.cgroup.policy import POLICY_ENGINE
    assert POLICY_ENGINE.enforce is True  # the harness's stop puts it back
