"""Chaos invariant 10: a worker's death in a mount batch, its restart and the
ledger's replay, on the port's harness (``testing/chaos.py``) against the
reference's.

For each site of the reference's ``CRASH_SITES`` both harnesses mount a
slice of 2 into one pod under a one-shot crash there, restart the node's
worker over its ledger and replay; the replay's summary, the GPUs mounted,
booked and held in the ledger, and the invariants' verdict must be equal.
Then the port's seeded crash scenario at the reference's three seeds, and
the negative control of ``tests/test_recovery_chaos.py``: a death with no
replay after it must be named by invariant 10, on both. Last, invariant 12:
a stale shard owner's writes fenced by the worker, on the reference's seeds.
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


@pytest.mark.parametrize("seed", SEEDS)
def test_worker_crash_chaos(tmp_path, seed):
    with ChaosHarness(str(tmp_path), seed) as h:
        h.run_worker_crash_scenario(n_ops=6)
        h.check_invariants()
        assert any(line.startswith("restart worker") for line in h.schedule), h.schedule


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
