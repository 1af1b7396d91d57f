"""Chaos invariant 10: a worker's death in a mount batch, its restart and the
ledger's replay, on the port's harness (``testing/chaos.py``) against the
reference's.

For each site of the reference's ``CRASH_SITES`` both harnesses mount a
slice of 2 into one pod under a one-shot crash there, restart the node's
worker over its ledger and replay; the replay's summary, the GPUs mounted,
booked and held in the ledger, and the invariants' verdict must be equal.
Then the port's seeded crash scenario at the reference's three seeds, and
the negative control of ``tests/test_recovery_chaos.py``: a death with no
replay after it must be named by invariant 10, on both. Then invariant 12:
a stale shard owner's writes fenced by the worker, on the reference's seeds.
Last, invariant 11: a node killed under live intents is evacuated by the
recovery controller, and the stranded intents converge on the other node once
their pods are rescheduled, its counts and outcomes the reference's on the
same seeds; a node that never confirms dead is named.
"""

from __future__ import annotations

import shutil

import pytest
from torch_durability import short_root, summary_shape
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.faults import failpoints as ref_failpoints
from gpumounter_tpu.faults.failpoints import CrashError as RefCrashError
from gpumounter_tpu.master.slice_ops import SliceError as RefSliceError
from gpumounter_tpu.master.slice_ops import SliceTarget as RefTarget
from gpumounter_tpu.testing import chaos as ref_chaos
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.faults.failpoints import CrashError
from gpumounter_tpu_torch.master.slice_ops import SliceError, SliceTarget
from gpumounter_tpu_torch.testing import chaos
from gpumounter_tpu_torch.testing.chaos import ChaosHarness

SEEDS = [7, 1337, 20260803]

#: (harness module, failpoints, SliceTarget, the errors a crashed mount raises,
#: the coordinator, held, booked)
SIDES = {
    "reference": (ref_chaos, ref_failpoints, RefTarget, (RefSliceError, RefCrashError),
                  lambda h: h._coordinator(), lambda h: h.held_chips(),
                  lambda h: h.booked_chips()),
    "port": (chaos, failpoints, SliceTarget, (SliceError, CrashError),
             lambda h: h.coordinator(), lambda h: h.held_gpus(), lambda h: h.booked_gpus()),
}


def _index(h, node, uuids) -> set[int]:
    by_uuid = {d.uuid: d.index for d in h.cluster.node(node).backend.list_devices()}
    return {by_uuid[u] for u in uuids}


def _crash_site(name, tmp_path, site, action, replay: bool):
    """One side's crashed mount of 2, then (with `replay`) the restart: the
    replay's summary, the GPUs held, booked and in the ledger, the open
    txns, and the invariants' verdict. The reference's run goes under a
    short root: its kubelets' unix sockets must stay under 107 bytes."""
    mod, fp, target, errors, coordinator, held_of, booked_of = SIDES[name]
    root = short_root() if name == "reference" else str(tmp_path / name)
    try:
        with mod.ChaosHarness(root, seed=1) as h:
            h.check_ledgers = True
            h.add_pod("victim", mod.NODE_A)
            with fp.armed({site: action}):
                with pytest.raises(errors):
                    coordinator(h).mount_slice([target(namespace="default", pod="victim")], 2,
                                               entire=False)
            summary = summary_shape(h.restart_worker(mod.NODE_A)) if replay else None
            key = ("default", "victim")
            ledger = h.services[mod.NODE_A].ledger
            view = (_index(h, mod.NODE_A, held_of(h)[key]),
                    _index(h, mod.NODE_A, booked_of(h)[key]),
                    _index(h, mod.NODE_A, ledger.net_holdings().get(key, set())),
                    len(ledger.open_transactions()))
            try:
                h.check_invariants()
                verdict = "held"
            except mod.InvariantViolation as exc:
                verdict = ("ledger" in str(exc), "seed=1" in str(exc))
        return summary, view, verdict
    finally:
        if name == "reference":
            shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("site, action", chaos.ChaosHarness.CRASH_SITES,
                         ids=lambda v: v.split("(")[0].replace("->", "-"))
def test_a_crash_site_converges_as_the_references(tmp_path, site, action):
    got = {name: _crash_site(name, tmp_path, site, action, replay=True) for name in SIDES}
    assert got["port"] == got["reference"]
    summary, (held, booked, ledger, open_txns), verdict = got["port"]
    assert summary["open"] == 1 and verdict == "held" and open_txns == 0
    assert held == booked == ledger and len(held) == 2


def test_the_crash_sites_are_the_references():
    assert chaos.ChaosHarness.CRASH_SITES == ref_chaos.ChaosHarness.CRASH_SITES


def _draws(schedule) -> list[str]:
    return [line.split("(")[0] for line in schedule
            if line.startswith(("arm ", "intent ", "crash-mount", "reconcile "))]


@pytest.mark.parametrize("seed", SEEDS)
def test_worker_crash_chaos(tmp_path, seed):
    """Deaths in mount batches, restarts and replays, between healthy adds
    and reconciles of the pods' intents; converged through the intents, as
    the reference's, on its draws."""
    with ChaosHarness(str(tmp_path), seed) as h:
        h.run_worker_crash_scenario(n_ops=6)
        h.check_invariants()
        assert any(line.startswith("restart worker") for line in h.schedule), h.schedule
        port = _draws(h.schedule)
    root = short_root()
    try:
        with ref_chaos.ChaosHarness(root, seed) as h:
            h.run_worker_crash_scenario(n_ops=6)
            h.check_invariants()
            ref = _draws(h.schedule)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert [d.split(" ->")[0] for d in port] == [d.split(" ->")[0] for d in ref]


def test_worker_crash_scenario_detects_broken_replay(tmp_path):
    """A chaos suite that cannot fail proves nothing: a death after the
    grant and no replay (the ledger carried over, never converged) is named
    by invariant 10, with the seed, on both harnesses."""
    site, action = "worker.mount.after_grant", "1*crash(negative)"
    got = {name: _crash_site(name, tmp_path, site, action, replay=False) for name in SIDES}
    assert got["port"] == got["reference"]
    assert got["port"][2] == (True, True)


# --- invariant 12: a stale shard owner, fenced ---


@pytest.mark.parametrize("seed", SEEDS)
def test_fencing_chaos(seed):
    """A ghost owner's writes at its stale epoch are all fenced and change
    nothing, while the successor's land; the port's scenario draws the
    reference's stale operations and live adds on the same seed."""
    def ops(schedule):
        return [step for step in schedule if "FENCED" in step or step.startswith("new owner add")]

    schedule = chaos.run_fencing_scenario(seed)
    assert any("fencing held" in step for step in schedule)
    assert ops(schedule) == ops(ref_chaos.run_fencing_scenario(seed))


# --- invariant 11, its first half: a node's death, detected and evacuated ---

def _reference_node_kill(seed: int) -> dict:
    """The reference's whole node-kill scenario on the same seed (under a
    short root: its kubelets' unix sockets)."""
    root = short_root()
    try:
        with ref_chaos.ChaosHarness(root, seed) as h:
            out = h.run_node_kill_scenario(n_pods=2)
            h.check_invariants()
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_node_kill_chaos(tmp_path, seed):
    """NODE_A dies under two victims' intents: tracked while alive,
    evacuated within the deadline, none of its pool pods left; each victim,
    rescheduled on NODE_B, converges there, and the invariants hold. Held to
    the reference's run on the same seed: the victims' counts are its draws,
    its re-converged outcomes (phase, desired, actual, healed) are the
    port's, and its evacuation released as many bookings in as many
    passes."""
    with ChaosHarness(str(tmp_path), seed) as h:
        out = h.run_node_kill_scenario(n_pods=2)
        h.check_invariants()
        held = h.held_gpus()
    assert len(out["evacuation"]) == 1 and out["evacuation"][0]["node"] == chaos.NODE_A
    assert out["detect_ms"] < 30_000
    ref = _reference_node_kill(seed)
    assert out["victims"] == {name: r["actual"] for name, r in ref["reconverged"].items()}

    def shape(outcomes):
        return {name: (o["phase"], o["desired"], o["actual"], o["healed"])
                for name, o in outcomes.items()}

    assert shape(out["reconverged"]) == shape(ref["reconverged"])
    assert {name: len(held[("default", name)]) for name in out["victims"]} == out["victims"]
    assert out["detect_passes"] == ref["detect_passes"]
    assert len(out["evacuation"][0]["released_bookings"]) == \
        len(ref["evacuation"][0]["released_bookings"]) == sum(out["victims"].values())


def test_a_node_kill_without_recovery_is_detected(tmp_path):
    """A chaos check that cannot fail proves nothing: a killed node whose
    controller never confirms (a Ready Node, as a worker's crash looks) is
    named by the scenario, with the seed."""
    with ChaosHarness(str(tmp_path), seed=7) as h:
        real_kill = h.kill_node

        def kill_but_ready(name):
            real_kill(name)
            h.cluster.kube.set_node_ready(name, True)

        h.kill_node = kill_but_ready
        with pytest.raises(chaos.InvariantViolation) as err:
            h.run_node_kill_scenario(n_pods=1, deadline_s=1.0)
    assert "never evacuated" in str(err.value) and "seed=7" in str(err.value)
