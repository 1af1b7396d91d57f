"""The port's base chaos harness (``gpumounter_tpu_torch/testing/chaos.py``).

The counterparts of ``tests/test_chaos.py``'s controls run on both
packages' harnesses, and what each found must be the same: the disabled
rollback is detected (an ownerless grant, with the seed in the message), the
slice's admission failpoint fails clean, and the skipped slice rollback
leaves one host's GPU mounted and booked. Then the port's seeded mount
scenario at three seeds, whose invariants 1-3, 5 and 6 must hold (its pool
holds the reference's crash terms, converged by the ledger's replay), and the
reproducibility of its schedule. Then invariants 7 (the channel pool's
books), 15 (the lock order) and 22 (the watch store against a fresh list,
with its poisoned-index control) on both harnesses, and invariant 9 (one
owner a shard) on the reference's seeds, its decisions the reference's.
"""

from __future__ import annotations

import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.faults import failpoints as ref_failpoints
from gpumounter_tpu.master.slice_ops import SliceError as RefSliceError
from gpumounter_tpu.master.slice_ops import SliceTarget as RefTarget
from gpumounter_tpu.testing import chaos as ref_chaos
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.master.slice_ops import SliceError, SliceTarget
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


@pytest.mark.parametrize("seed", SEEDS)
def test_mount_chaos(tmp_path, seed):
    with ChaosHarness(str(tmp_path), seed) as h:
        h.run_mount_scenario(n_ops=8)
        h.check_invariants()
        assert any(line.startswith("arm ") for line in h.schedule), h.schedule


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
    live channels than workers, are each named."""
    with ChaosHarness(str(tmp_path), seed=11) as h:
        h.channel_pool._dialed += 1
        with pytest.raises(InvariantViolation) as err:
            h.check_invariants()
        assert "channel-pool books off" in str(err.value)
        h.channel_pool._dialed -= 1
        for i in range(3):
            h.channel_pool.channel(f"127.0.0.1:{1 + i}")
        with pytest.raises(InvariantViolation) as err:
            h.check_invariants()
        assert "channel leak: 3 live channel(s) for 2 worker(s)" in str(err.value)


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
